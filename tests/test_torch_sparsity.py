"""Port parity of the sparsity prior (ingp_tpu/training/trainer.py:
279-295): one training step of the brick stream encoder with the prior
(test_torch_train_variants.py's `check_step`), and the prior's density
on JAX's own draw of its points.

The prior's 16,384 points are JAX's own draw, uniform(fold_in(fold_in(
PRNGKey(seed + 1), step), 7)) (ingp_tpu/training/trainer.py:280,374),
handed to the port as batch["sparsity_points"]; its loss term is held
to rtol 1e-5 on its own, since at 1e-3 it sits below the total's
tolerance. The step's bounds and measured values are in
test_torch_train_variants.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from ingp_tpu.models import ngp as jngp
from ingp_tpu_torch.core import prng
from ingp_tpu_torch.data.synthetic import SyntheticDataset
from ingp_tpu_torch.models import ngp as tngp
from ingp_tpu_torch.training import trainer as tt
from tests.test_torch_train import N, T
from tests.test_torch_train_variants import (check_step, jax_prior_points,
                                             setup)
from tests._torch_threads import one_torch_thread  # noqa: F401


def test_train_step_with_sparsity_prior_matches():
    check_step("brick, sparsity prior")


def test_sparsity_prior_on_jax_draw():
    """The prior's density (and the loss term lambda * mean sigma) of the
    port's row-major `ngp_sigma` on JAX's own draw of the points, against
    JAX's `ngp_sigma`, to rtol 1e-5 plus 1e-6 of the largest sigma."""
    h, jsys, params, *_ = setup("brick, sparsity prior")
    pts = jax_prior_points(jsys, 3)
    assert pts.shape == (tt.SPARSITY_POINTS, 3)
    assert np.abs(pts).max() <= jsys.model_cfg.scale
    sig_j = np.asarray(jngp.ngp_sigma(jsys.model_cfg, jax.tree.map(
        jnp.asarray, params["model"]), jnp.asarray(pts)))
    cfg = tt.model_config_from_hparams(h)
    sig_t = tngp.ngp_sigma(cfg, tngp.params_from_numpy(params["model"],
                                                       cfg=cfg), T(pts))
    np.testing.assert_allclose(N(sig_t), sig_j, rtol=1e-5,
                               atol=1e-6 * np.abs(sig_j).max())
    lam = h.sparsity_loss
    np.testing.assert_allclose(lam * float(sig_t.mean()),
                               lam * float(sig_j.mean()), rtol=1e-5)
    # without injected draws the port makes JAX's own: the prior's
    # points and the ray jitter of a step, from fold_in(PRNGKey(seed + 1),
    # step), bit for bit
    psys = tt.NeRFSystem(h, SyntheticDataset(split="train", img_size=8,
                                             n_train=2), device="cpu")
    psys.global_step = 3
    draws = psys.step_draws(300)
    assert torch.equal(draws["sparsity_points"], T(pts))
    key = jax.random.split(jax.random.fold_in(jsys._base_key, 3))[0]
    assert torch.equal(draws["noise"], T(jax.random.uniform(key, (300,))))
    psys.global_step = 4
    assert not torch.equal(psys.step_draws(0)["sparsity_points"], T(pts))
    assert torch.equal(psys.step_draws(300, step=3)["noise"],
                       draws["noise"])


def test_grid_refresh_takes_f32_densities():
    """The port's grid refresh takes the density MLP at f32 whatever the
    compute dtype, a deliberate departure from the JAX trainer, which
    takes it at the compute dtype (ingp_tpu/training/trainer.py:401).
    At bf16 tables and MLPs, a fresh model's first warmup sweep
    (NeRFSystem.maybe_update_grid, its draws from PRNGKey(0)) gives the
    grid of JAX's update_density_grid run with JAX's ngp_sigma at f32
    compute on the same parameters, start grid and key: densities to
    rtol 1e-5 (atol 1e-5), and the bitfield but for cells whose density
    lies within that tolerance of the occupancy threshold. That
    field is continuous, with about half the cells occupied; the
    reference's own bf16 refresh of the same model is flat (at most a
    few distinct densities over every cell), so "density > mean" marks
    nearly all or nearly none of the cells as the rounding falls."""
    import dataclasses
    import jax
    from ingp_tpu.data.synthetic import SyntheticDataset as JData
    from ingp_tpu.grid import occupancy as jocc
    from ingp_tpu.training import trainer as jt
    from ingp_tpu_torch.models.rendering import MAX_SAMPLES
    from tests.test_torch_faults import _hparams
    h = _hparams(compute_dtype="bfloat16", table_dtype="bfloat16")
    jsys = jt.NeRFSystem(h, JData(split="train", img_size=8, n_train=2))
    params = jax.tree.map(lambda a: np.array(a, np.float32), jsys.params)
    psys = tt.NeRFSystem(h, SyntheticDataset(split="train", img_size=8,
                                             n_train=2),
                         device="cpu", params=params)
    grid_t = {k: T(v) for k, v in jsys.grid.items()}
    for k in ("bitfield", "block_table"):
        grid_t[k] = grid_t[k].to(torch.int32)
    psys.grid = grid_t
    psys.maybe_update_grid()

    cfg = jsys.model_cfg
    G, C = cfg.grid_size, cfg.cascades
    thr = h.density_threshold * MAX_SAMPLES / np.sqrt(3)
    jparams = jax.tree.map(jnp.asarray, params["model"])

    def jax_refresh(compute_dtype):
        c = dataclasses.replace(cfg, compute_dtype=compute_dtype)
        return jocc.update_density_grid(
            lambda prm, x: jngp.ngp_sigma(c, prm, x), jparams, jsys.grid,
            jax.random.PRNGKey(0), thr, G, C, cfg.scale, True)

    grid_j = jax_refresh("float32")
    np.testing.assert_allclose(N(psys.grid["density_grid"]),
                               N(grid_j["density_grid"]), rtol=1e-5,
                               atol=1e-5)

    def bits(grid):
        words = np.asarray(grid["bitfield"]).astype(np.uint32)
        return np.unpackbits(words.view(np.uint8), bitorder="little")

    # a cell's bit may differ only where its density lies within the
    # densities' tolerance of the reference's threshold, min(mean, thr)
    dg = N(grid_j["density_grid"]).reshape(-1)
    pos = dg > 0
    cut = min(dg[pos].mean(), thr)
    flip = bits(psys.grid) != bits(grid_j)
    assert np.all(np.abs(dg[flip] - cut) <= 1e-5 * cut + 1e-5), (
        flip.sum(), np.abs(dg[flip] - cut).max(), cut)

    def occupied(grid):
        return bits(grid).mean()

    def distinct(grid):
        dg = np.asarray(grid["density_grid"])
        return np.unique(dg[dg > 0]).size

    assert 0.3 < occupied(grid_j) < 0.7
    assert distinct(grid_j) > 100
    flat = jax_refresh("bfloat16")
    assert distinct(flat) <= 3
    assert not 0.1 < occupied(flat) < 0.9
