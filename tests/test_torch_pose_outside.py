"""Pose refinement (`optimize_ext`) with every camera outside the scene's
box, port against the JAX package on CPU: the departure of ROADMAP.md
Queue 3 ("JAX's march t values carry a gradient through the box entry
for a camera outside the box").

The synthetic scene's cameras sit on a sphere of radius 1.35 around a
box of half-width 0.5, so every ray enters the box at t > NEAR_DISTANCE
and JAX's `clamp_near(ray_aabb_intersect(rays_o, ...))` depends on the
refined pose: its t values, and so its sample positions o + t d, carry
a gradient through the entry (ingp_tpu/models/rendering.py:154-155).
The port holds t fixed (ingp_tpu_torch/models/rendering.py `_march`),
as JAX's own comment on the march says it should.

(a) With JAX's entry held fixed (a stop_gradient around its
    `ray_aabb_intersect`, monkeypatched inside the test), one f32 step's
    loss and every gradient leaf, ext's dR and dT included, equal the
    port's (1e-4 of each leaf's largest value, as
    tests/test_torch_pose_refine.py holds them).
(b) Without it, JAX's ext gradients differ from the port's by more than
    1e-2 of their largest value, and the difference is the box-entry
    term: JAX's ext gradient less JAX's with the entry held, to 1e-4.
    The other leaves do not see the entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ingp_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from ingp_tpu.models import rendering as jr
from ingp_tpu.ops import pack as jp
from ingp_tpu.ops.march import build_block_table
from ingp_tpu.training import trainer as jt
from ingp_tpu_torch.data.synthetic import SyntheticDataset, sphere_density_grid
from ingp_tpu_torch.grid.occupancy import grid_from_density
from ingp_tpu_torch.models.ngp import hash_layout
from ingp_tpu_torch.training import trainer as tt
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_pose_refine import _grads_of, _smooth
from tests.test_torch_train import N, T, hparams

IMG, VIEWS, RAYS = 24, 4, 256


@pytest.fixture(scope="module")
def setup():
    """The JAX and port systems' shared start: hparams, both datasets,
    the smoothed parameters, the scene's sphere occupancy (JAX's bitfield
    and block table, the port's grid), one batch with its jitter."""
    h = hparams("f32", encoder="hash", stream_dedup=False,
                optimize_ext=True)
    jtr = JaxSynthetic(split="train", img_size=IMG, n_train=VIEWS)
    tr = SyntheticDataset(split="train", img_size=IMG, n_train=VIEWS)
    jsys = jt.NeRFSystem(h, jtr, jtr)
    params = _smooth(jax.tree.map(lambda a: np.array(a, np.float32),
                                  jsys.params), jsys.model_cfg, h.encoder)
    cfg = jsys.model_cfg
    dg = sphere_density_grid(cfg.grid_size, cfg.cascades, cfg.scale)
    bits = jp.packbits_u32(dg.reshape(-1), 0.5)
    grid = {"bitfield": np.asarray(bits), "block_table": np.asarray(
        build_block_table(bits, cfg.grid_size, cfg.cascades))}
    rng = np.random.default_rng(0)
    batch = tr.sample_batch(rng, RAYS)
    batch["noise"] = rng.random(RAYS, dtype=np.float32)
    return dict(h=h, jtr=jtr, tr=tr, params=params, grid=grid, dg=dg,
                batch=batch)


def _jax_grads(s, hold_entry, monkeypatch):
    """JAX's loss and clipped gradient leaves after one train_step, its
    box entry held fixed or not (a fresh system, and jit's caches
    cleared: `render_rays` is traced anew with the entry as it is)."""
    jax.clear_caches()
    if hold_entry:
        entry = jr.ray_aabb_intersect
        monkeypatch.setattr(jr, "ray_aabb_intersect", lambda *a: (
            jax.lax.stop_gradient(entry(*a))))
    j = jt.NeRFSystem(s["h"], s["jtr"], s["jtr"])
    params = jax.tree.map(jnp.asarray, s["params"])
    grid = jax.tree.map(jnp.asarray, s["grid"])
    batch = {k: jnp.asarray(v) for k, v in s["batch"].items()
             if k in j.BATCH_KEYS}
    _, opt_state, _, aux = j.train_step(
        params, j.tx.init(params), grid["bitfield"], grid["block_table"],
        j.directions, j.poses, batch, jnp.int32(0), j._base_key)
    monkeypatch.undo()
    return float(aux["loss"]), _grads_of(opt_state)


def _port_grads(s):
    cfg = s["h"]
    psys = tt.NeRFSystem(cfg, s["tr"], device="cpu", params=s["params"])
    psys.grid = grid_from_density(psys.grid, T(s["dg"]), 0.5,
                                  psys.model_cfg.grid_size,
                                  psys.model_cfg.cascades)
    b = s["batch"]
    aux, grads = psys.loss_and_grads(b, T(b["noise"]))
    tt.clip_by_global_norm([g for _, g in tt.tree_leaves(grads)])
    grads["model"] = hash_layout(grads["model"], psys.model_cfg)
    return float(aux["loss"]), {k: N(g) for k, g in tt.tree_leaves(grads)}


@pytest.fixture(scope="module")
def grads(setup):
    """{"port", "held", "jax"}: (loss, {leaf: gradient}) of the port,
    of JAX with its entry held fixed and of JAX as it is."""
    mp = pytest.MonkeyPatch()
    try:
        return {"port": _port_grads(setup),
                "held": _jax_grads(setup, True, mp),
                "jax": _jax_grads(setup, False, mp)}
    finally:
        mp.undo()


def _err(a, b):
    return float(np.abs(a - b).max()), float(np.abs(b).max())


def test_cameras_are_outside_the_box(setup):
    """Every training camera outside the box: the entry is no clamp."""
    eyes = setup["tr"].poses[:, :, 3]
    assert (np.abs(eyes).max(1) > setup["h"].scale).all()


def test_ext_gradient_equals_jax_with_the_entry_held(grads):
    """(a): the loss and every leaf, ext's included."""
    loss, g_t = grads["port"]
    loss_j, g_j = grads["held"]
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    assert set(g_t) == set(g_j)
    for key, g in g_t.items():
        frac = 3e-4 if key[:2] == ("model", "norm_net") else 1e-4
        err, scale = _err(g, g_j[key])
        assert err <= frac * scale, (key, err, scale)
    for leaf in ("dR", "dT"):
        assert np.abs(g_j[("ext", leaf)]).max() > 0


@pytest.mark.parametrize("leaf", ["dR", "dT"])
def test_ext_gradient_differs_from_jax_by_the_box_entry_term(grads, leaf):
    """(b): JAX's own ext gradient moves off the port's by the entry's
    term, which is JAX's less JAX's with the entry held."""
    key = ("ext", leaf)
    g_t = grads["port"][1][key]
    g_j, g_h = grads["jax"][1][key], grads["held"][1][key]
    scale = float(np.abs(g_j).max())
    entry = g_j - g_h
    assert float(np.abs(g_j - g_t).max()) > 1e-2 * scale
    assert float(np.abs((g_j - g_t) - entry).max()) <= 1e-4 * scale


def test_the_entry_moves_only_ext(grads):
    """The loss and the network's leaves do not depend on the entry's
    gradient, so JAX as it is equals the port there."""
    loss, g_t = grads["port"]
    loss_j, g_j = grads["jax"]
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    for key, g in g_t.items():
        if key[0] == "ext":
            continue
        frac = 3e-4 if key[:2] == ("model", "norm_net") else 1e-4
        err, scale = _err(g, g_j[key])
        assert err <= frac * scale, (key, err, scale)
