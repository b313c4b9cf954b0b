"""Port parity: brick grid encoder and kernel K2 (the fused-gather brick
reduce) against ingp_tpu's brickgrid and its Pallas fused_brick_reduce
run in interpret mode, on CPU (the wrapper runs K2's plain version for
CPU tensors)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ingp_tpu.ops import brickgrid as jb
from ingp_tpu.ops.pallas.brickreduce_pallas import fused_brick_reduce

from ingp_tpu_torch.kernels import brickreduce as k2
from ingp_tpu_torch.kernels import build
from ingp_tpu_torch.ops import brickgrid as tb
from tests._torch_threads import one_torch_thread  # noqa: F401

CFG_ARGS = dict(n_levels=6, n_features=4, log2_bricks=9,
                base_resolution=8, per_level_scale=1.6)
JCFG = jb.BrickGridConfig(**CFG_ARGS)
TCFG = tb.BrickGridConfig(**CFG_ARGS)

# f32 sums of 8 weighted corners taken in another order than XLA's
# lane-plane dot: agreement to a few f32 ulps of the O(1) values
RTOL, ATOL = 1e-5, 1e-6
# XLA's CPU dot over the 256-lane weight planes strays from a float64
# reference by up to ~1.2e-6 on O(0.1) corner values (the port is
# within 1e-9 of it), so the encoder tests allow 1e-4 of the corner
# scale
ENC_ATOL = 1e-5


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return np.asarray(a)


def test_config_derived_fields_match():
    for args in (CFG_ARGS, dict(n_levels=16, n_features=8, log2_bricks=16,
                                per_level_scale=1.3819)):
        j, t = jb.BrickGridConfig(**args), tb.BrickGridConfig(**args)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.row_width, j.out_dim, j.lattice_pts) == \
            (t.row_width, t.out_dim, t.lattice_pts)


def test_brick_coords_match():
    x = np.random.default_rng(0).uniform(0, 1, (3, 700)).astype(np.float32)
    x[:, :5] = [[0, 1, 0.5, 1, 0]] * 3          # lattice edges
    rj, lj, fj = jb.brick_coords(JCFG, x)
    rt, lt, ft = tb.brick_coords(TCFG, T(x))
    np.testing.assert_array_equal(N(rt), N(rj))
    np.testing.assert_array_equal(N(lt), N(lj))
    np.testing.assert_array_equal(N(ft), N(fj))
    assert any(JCFG.hashed) and not all(JCFG.hashed)


def _k2_inputs(seed, Lw, n, W, F, n_rows, dtype=np.float32, overflow=True):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n_rows, W)).astype(np.float32)
    rows = rng.integers(0, n_rows, (Lw, n)).astype(np.int32)
    loc = rng.integers(0, 2, (3, Lw, n)).astype(np.float32)
    if overflow:
        loc[:, :, ::7] = -9.0                 # overflow / padding marker
    frac = rng.uniform(0, 1, (3, Lw, n)).astype(np.float32)
    sc = np.broadcast_to(rng.uniform(5, 50, (1, Lw, 1)), (1, Lw, n))
    lf = np.concatenate([loc, frac, sc, np.zeros((1, Lw, n))], 0
                        ).astype(np.float32)
    if dtype == "bf16":
        table = N(jnp.asarray(table, jnp.bfloat16).astype(jnp.float32))
    return table, rows, lf


@pytest.mark.parametrize("bf16", [False, True])
def test_k2_plain_matches_pallas_interpret(bf16):
    F, W, Lw, n = 8, 256, 2, 512
    table, rows, lf = _k2_inputs(1, Lw, n, W, F, 300,
                                 "bf16" if bf16 else np.float32)
    jt = jnp.asarray(table, jnp.bfloat16 if bf16 else jnp.float32)
    g = jt[rows.reshape(-1)]
    fj, jj = fused_brick_reduce(g, lf.reshape(8, -1), F, True)
    tt = T(table).to(torch.bfloat16) if bf16 else T(table)
    ft, jt_ = k2.brick_reduce(tt, T(rows), T(lf), F, True)
    # port layout (N, Lw*F) / (3, N, Lw*F) vs feature-major (F, Lw*n)
    fj = N(fj).reshape(F, Lw, n).transpose(2, 1, 0).reshape(n, Lw * F)
    jj = N(jj).reshape(3, F, Lw, n).transpose(0, 3, 2, 1).reshape(3, n, -1)
    np.testing.assert_allclose(N(ft), fj, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(N(jt_), jj, rtol=RTOL, atol=1e-4)
    assert (N(ft)[::7] == 0).all()


@pytest.mark.parametrize("window", [(0, None), (1, 3)])
def test_k2_plain_matches_reduce_feats_jac(window):
    F, W, Lw, n = 4, 128, 3, 200
    jac_lo, jac_hi = window
    table, rows, lf = _k2_inputs(2, Lw, n, W, F, 97)
    g = table[rows.reshape(-1)]
    local, frac = lf[0:3], lf[3:6]
    cfg = jb.BrickGridConfig(n_levels=Lw, n_features=F, log2_bricks=8)
    lf[6] = np.asarray(cfg.scales, np.float32)[:, None]
    # the JAX form reduces pre-gathered rows g; K2 takes table and ids
    fj, jj = jb.reduce_feats_jac(cfg, g, local, frac, n, jac_lo, jac_hi)
    ft, jt = k2.brick_reduce_plain(T(table), T(rows), T(lf), F, True,
                                   jac_lo, jac_hi)
    np.testing.assert_allclose(N(ft), N(fj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(N(jt), N(jj), rtol=RTOL, atol=1e-4)
    ft2, jt2 = k2.brick_reduce(T(table), T(rows), T(lf), F, False)
    assert jt2 is None
    np.testing.assert_allclose(
        N(ft2), N(jb.reduce_feats(cfg, g, local, frac, n)), rtol=RTOL,
        atol=ATOL)


def test_k2_plain_chunking_is_invisible(monkeypatch):
    F, W, Lw, n = 4, 128, 3, 300
    table, rows, lf = _k2_inputs(3, Lw, n, W, F, 50)
    ref = k2.brick_reduce(T(table), T(rows), T(lf), F, True)
    monkeypatch.setattr(k2, "PLAIN_CHUNK", 16)
    out = k2.brick_reduce(T(table), T(rows), T(lf), F, True)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(N(a), N(b))


@pytest.mark.parametrize("storage", [None, "bfloat16"])
def test_brickgrid_encode_matches(storage):
    table = N(jb.brickgrid_init(jax.random.PRNGKey(0), JCFG))
    table = table * 1e3                          # O(0.1) features
    x = np.random.default_rng(4).uniform(0, 1, (3, 900)).astype(np.float32)
    sd = None if storage is None else jnp.bfloat16
    fj = jb.brickgrid_encode(JCFG, table, x, chunk=256, storage_dtype=sd,
                             x_cm=True)
    ft = tb.brickgrid_encode(TCFG, T(table), T(x), chunk=256,
                             storage_dtype=storage, x_cm=True)
    np.testing.assert_allclose(N(ft), N(fj), rtol=RTOL, atol=ENC_ATOL)
    fj, jj = jb.brickgrid_encode_grad(JCFG, table, x, chunk=256,
                                      storage_dtype=sd, x_cm=True)
    ft, jt = tb.brickgrid_encode_grad(TCFG, T(table), T(x), chunk=256,
                                      storage_dtype=storage, x_cm=True)
    np.testing.assert_allclose(N(ft), N(fj), rtol=RTOL, atol=ENC_ATOL)
    # jacobian entries carry the level scale (up to ~85 here)
    np.testing.assert_allclose(N(jt), N(jj), rtol=RTOL, atol=1e-3)


def test_k2_wrapper_rejects_other_devices():
    table, rows, lf = _k2_inputs(5, 1, 8, 128, 4, 10)
    n0 = build.LAUNCHES["ingp_brick_reduce_fwd"]
    with pytest.raises(ValueError):
        k2.brick_reduce(T(table).to("meta"), T(rows), T(lf), 4)
    assert build.LAUNCHES["ingp_brick_reduce_fwd"] == n0
