"""Port parity of one training step on the encoder variants beside the
bench's (test_torch_train.py holds that one): the hash encoder (f32
tables, stream_dedup off: the CLI's default encoder) and the per-sample
brick encoder (stream_dedup off), each against the JAX `train_step` on
CPU; test_torch_sparsity.py runs the brick stream encoder with the
sparsity prior through the same check (`check_step`).

Both sides start from the same numpy parameters (the JAX system's, in
its layouts: the hash tables feature-major, which the port transposes),
the same sphere grid, batch and ray jitter.

The bounds are test_torch_train.py's (measured values in brackets, for
hash / brick with the prior / per-sample brick): the loss to rtol 1e-5;
every clipped gradient leaf to 1e-4 of its largest |value| [2.0e-5,
4.0e-5, 3.9e-5], norm_net's to 3e-4 [1.8e-4, 1.0e-4, 1.0e-4]; the
update to 1e-4 on entries whose Adam denominator stays above ADAM_FLOOR
[3.0e-5, 3.9e-5, 3.6e-5]; the parameters after the step to 1e-3
[1.7e-4, 6.6e-5, 1.9e-4].
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ingp_tpu.data.synthetic import SyntheticDataset as JData
from ingp_tpu.ops import pack as jp
from ingp_tpu.ops.march import build_block_table
from ingp_tpu.training import trainer as jt

from ingp_tpu_torch.data.synthetic import SyntheticDataset, \
    sphere_density_grid
from ingp_tpu_torch.grid.occupancy import grid_from_density
from ingp_tpu_torch.models import ngp as tngp
from ingp_tpu_torch.training import trainer as tt
from tests.test_torch_train import (N, R_BATCH, T, _adam_moments,
                                    _leaf_close, _update_close, hparams,
                                    jax_grouped)

VARIANTS = {
    "hash": dict(encoder="hash", stream_dedup=False),
    "brick, per sample": dict(stream_dedup=False),
    # test_torch_sparsity.py
    "brick, sparsity prior": dict(sparsity_loss=1e-3),
}


def jax_prior_points(jsys, step):
    """The points JAX's train_step draws for the prior at `step`."""
    key = jax.random.fold_in(jax.random.fold_in(jsys._base_key, step), 7)
    s = jsys.model_cfg.scale
    return np.asarray(jax.random.uniform(key, (tt.SPARSITY_POINTS, 3),
                                         minval=-s, maxval=s))


def setup(variant):
    """(hparams, JAX system, numpy params, sphere grid bits, the port's
    dataset and grid, one batch with its ray jitter)."""
    h = hparams(**VARIANTS[variant])
    jsys = jt.NeRFSystem(h, JData(split="train", img_size=24, n_train=4))
    params = jax.tree.map(lambda a: np.array(a, np.float32), jsys.params)
    params["model"]["density_table"] *= 1e4
    params["model"]["rgb_table"] *= 1e3
    cfg = jsys.model_cfg
    dg = sphere_density_grid(cfg.grid_size, cfg.cascades, cfg.scale)
    bits = jp.packbits_u32(dg.reshape(-1), 0.5)
    tr = SyntheticDataset(split="train", img_size=24, n_train=4)
    psys = tt.NeRFSystem(h, tr, device="cpu", params=params)
    grid = grid_from_density(psys.grid, T(dg), 0.5, cfg.grid_size,
                             cfg.cascades)
    rng = np.random.default_rng(0)
    batch = tr.sample_batch(rng, R_BATCH)
    batch["noise"] = rng.random(R_BATCH, dtype=np.float32)
    return h, jsys, params, bits, tr, grid, batch


def jax_step(jsys, params, bits, batch):
    """(aux, params after, opt_state after) of JAX's first train_step."""
    cfg = jsys.model_cfg
    p = jax.tree.map(jnp.asarray, params)
    with jax_grouped():
        b = {k: jnp.asarray(v) for k, v in batch.items()
             if k in jsys.BATCH_KEYS}
        p, st, _, aux = jsys.train_step(
            p, jsys.tx.init(p), bits,
            build_block_table(bits, cfg.grid_size, cfg.cascades),
            jsys.directions, jsys.poses, b, jnp.int32(0), jsys._base_key)
    return (jax.tree.map(N, aux), jax.tree.map(N, p),
            jax.tree.map(N, st))


def check_step(variant):
    """One step of `variant` on both sides: the loss (and the prior's
    term), every clipped gradient leaf, the update and the parameters,
    to test_torch_train.py's bounds."""
    h, jsys, params, bits, tr, grid, batch = setup(variant)
    aux_j, params_j, st_j = jax_step(jsys, params, bits, batch)
    mu_j, _ = _adam_moments(st_j)
    cfg = tt.model_config_from_hparams(h)
    prior = getattr(h, "sparsity_loss", 0.0) > 0
    if prior:
        batch["sparsity_points"] = jax_prior_points(jsys, 0)
    psys = tt.NeRFSystem(h, tr, device="cpu", params=params)
    psys.grid = grid
    aux, grads = psys.loss_and_grads(batch, T(batch["noise"]),
                                     batch.get("sparsity_points"))
    np.testing.assert_allclose(float(aux["loss"]), aux_j["loss"], rtol=1e-5)
    assert set(aux["loss_terms"]) == set(aux_j["loss_terms"])
    assert ("sparsity" in aux["loss_terms"]) == prior
    if prior:
        np.testing.assert_allclose(float(aux["loss_terms"]["sparsity"]),
                                   aux_j["loss_terms"]["sparsity"],
                                   rtol=1e-5)
    tt.clip_by_global_norm([g for _, g in tt.tree_leaves(grads)])
    g_port = tngp.params_to_numpy(grads, cfg)
    g_j = jax.tree.map(lambda m: m / np.float32(1 - 0.9), mu_j)
    for name in g_port["model"]:
        frac = 3e-4 if name == "norm_net" else 1e-4
        _leaf_close(g_port["model"][name], g_j["model"][name], frac, name)
    p0 = psys.params_to_numpy()
    psys.train_step(batch)
    _, held = _update_close(p0, psys.params_to_numpy(), params_j, [st_j],
                            1e-4, "update")
    assert held > 500
    _leaf_close(psys.params_to_numpy(), params_j, 1e-3, "param")


@pytest.mark.parametrize("variant", ["hash", "brick, per sample"])
def test_train_step_variant_matches(variant):
    check_step(variant)
