"""Port parity: the stream-dedup encoder and kernel K1 (fused unique-row
expand + trilerp reduce) against ingp_tpu's streambrick (grouped path,
its Pallas kernel in interpret mode) on CPU, where the K1 wrapper runs
its plain version."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ingp_tpu.ops import streambrick as js
from ingp_tpu.ops.brickgrid import BrickGridConfig as JCfg, brickgrid_init
from ingp_tpu.ops.pallas.rayreduce_pallas import fused_ray_reduce as j_frr

from ingp_tpu_torch.kernels import rayreduce as k1
from ingp_tpu_torch.ops import streambrick as ts
from ingp_tpu_torch.ops.brickgrid import BrickGridConfig as TCfg

ARGS = dict(n_levels=8, n_features=4, log2_bricks=10, base_resolution=16,
            per_level_scale=1.45)
JCFG, TCFG = JCfg(**ARGS), TCfg(**ARGS)


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return np.asarray(a)


def ray_stream(seed, n_rays=96, max_seg=24):
    """Ray-contiguous compact stream of t-ordered segments (3, N)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, max_seg, n_rays)
    o = rng.uniform(0, 1, (n_rays, 3)) * 0.5 + 0.25
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    xs = [np.clip(o[r] + np.arange(lens[r])[:, None] * (np.sqrt(3) / 1024)
                  * d[r], 0, 1) for r in range(n_rays)]
    return np.concatenate(xs).astype(np.float32).T


def test_caps_groups_and_split_match():
    for cfg_args, tile in ((ARGS, 256), (dict(n_levels=16, n_features=8,
                                              log2_bricks=14,
                                              per_level_scale=1.38), 256)):
        jc, tc = JCfg(**cfg_args), TCfg(**cfg_args)
        caps = js.stream_caps(jc, tile)
        assert ts.stream_caps(tc, tile) == caps
        Lc = js.split_levels(caps, tile, 0.7)
        assert ts.split_levels(caps, tile, 0.7) == Lc
        assert ts.group_levels(caps[:Lc]) == js.group_levels(caps[:Lc])
        # the test render's stream is unsorted: one tile class, formula
        # caps, no override
        for slack, seg in ((1.5, 4), (1.2, 8)):
            assert [ts._tile_classes(tc, tile, slack, seg, 0.7) + (32,)] \
                == js._tile_classes(jc, tile, 32, slack, seg, 0, 0.0, 0.7,
                                    None)


@pytest.mark.parametrize("Ug", [4, 16])
def test_unique_plan_uniform_matches(Ug):
    rng = np.random.default_rng(1)
    Lg, Tt, TS = 3, 4, 32
    # runs of random length, so that small caps overflow
    rows = np.cumsum(rng.random((Lg, Tt, TS)) < 0.3, axis=2).astype(np.int32)
    valid = np.ones((Tt, TS), bool)
    uj, rj, oj = js._unique_plan_uniform(rows, valid, Ug)
    ut, rt, ot = ts._unique_plan_uniform(T(rows), T(valid), Ug)
    np.testing.assert_array_equal(N(ut), N(uj))
    np.testing.assert_array_equal(N(rt), N(rj))
    np.testing.assert_array_equal(N(ot), N(oj))
    assert N(ot).any() == (Ug == 4)


def _k1_inputs(seed, B, U, K, W, F, bf16=False, n_rows=300):
    """(table, urows, uid, lf): the unique rows of batch row b are
    table[urows[b]], as the grouped plan makes them."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n_rows, W)).astype(np.float32)
    if bf16:
        table = N(jnp.asarray(table, jnp.bfloat16).astype(jnp.float32))
    urows = rng.integers(0, n_rows, (B, U)).astype(np.int32)
    # running run counts, clipped to the cap, as the grouped plan makes
    uid = np.minimum(np.cumsum(rng.random((B, K)) < 0.2, 1),
                     U - 1).astype(np.int32)
    loc = rng.integers(0, 2, (3, B, K)).astype(np.float32)
    loc[:, :, ::9] = -9.0
    frac = rng.uniform(0, 1, (3, B, K)).astype(np.float32)
    sc = np.full((1, B, K), 37.5, np.float32)
    lf = np.concatenate([loc, frac, sc, np.zeros((1, B, K), np.float32)])
    return table, urows, uid, lf


@pytest.mark.parametrize("bf16,with_jac,window", [
    (False, True, (0, None)), (False, False, (0, None)),
    (True, True, (0, None)), (False, True, (2, 6))])
def test_k1_plain_matches_pallas_interpret(bf16, with_jac, window):
    F, W, B, U, K = 8, 256, 8, 32, 128
    table, urows, uid, lf = _k1_inputs(2, B, U, K, W, F, bf16)
    jac_lo, jac_hi = window
    # the Pallas kernel takes the unique rows gathered, the port the
    # table and their ids
    jg = jnp.asarray(table[urows], jnp.bfloat16 if bf16 else jnp.float32)
    fj, jj = j_frr(jg, uid, lf, F, with_jac, jac_lo, jac_hi, True)
    tt = T(table).to(torch.bfloat16) if bf16 else T(table)
    ft, jt = k1.fused_ray_reduce(tt, T(urows), T(uid), T(lf), F, with_jac,
                                 jac_lo, jac_hi)
    # f32 sums in another order than the interpreted MXU dots; the
    # jacobian carries the level scale 37.5
    np.testing.assert_allclose(N(ft), N(fj), rtol=1e-5, atol=1e-5)
    if with_jac:
        np.testing.assert_allclose(N(jt), N(jj), rtol=1e-5, atol=1e-4)
    else:
        assert jt is None and jj is None
    assert (N(ft)[:, :, ::9] == 0).all()


def test_k1_plain_chunking_is_invisible(monkeypatch):
    args = [T(a) for a in _k1_inputs(3, 4, 8, 40, 128, 4, n_rows=20)]
    ref = k1.fused_ray_reduce(*args, 4)
    monkeypatch.setattr(k1, "PLAIN_CHUNK", 7)
    out = k1.fused_ray_reduce(*args, 4)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(N(a), N(b))


def test_k1_wrapper_rejects_other_devices():
    table, urows, uid, lf = _k1_inputs(4, 1, 4, 8, 128, 4)
    with pytest.raises(ValueError):
        k1.fused_ray_reduce(T(table).to("meta"), T(urows), T(uid), T(lf), 4)


def _jax_grouped(monkeypatch):
    """The JAX grouped stream path (the TPU default), run on CPU through
    the Pallas interpreter."""
    monkeypatch.setenv("INGP_STREAM_GROUPED", "1")
    monkeypatch.setenv("INGP_STREAM_GROUPED_INTERPRET", "1")
    js.streambrick_encode.clear_cache()
    js.streambrick_encode_grad.clear_cache()


@pytest.mark.parametrize("storage,stream", [(None, "rays"),
                                            ("bfloat16", "rays"),
                                            (None, "random")])
def test_stream_encode_matches_grouped_jax(monkeypatch, storage, stream):
    table = N(brickgrid_init(jax.random.PRNGKey(7), JCFG)) * 1e3
    if stream == "rays":
        x = ray_stream(8)
    else:
        # random points: nearly every sample is its own run, so the
        # tile caps overflow and the -9 marking is exercised
        x = np.random.default_rng(9).uniform(0, 1, (3, 1500)
                                             ).astype(np.float32)
    _jax_grouped(monkeypatch)
    sd = None if storage is None else jnp.bfloat16
    try:
        fj, jj = js.streambrick_encode_grad(JCFG, table, x, tile=256,
                                            storage_dtype=sd)
    finally:
        js.streambrick_encode.clear_cache()
        js.streambrick_encode_grad.clear_cache()
    ft, jt = ts.streambrick_encode_grad(TCFG, T(table), T(x), tile=256,
                                        storage_dtype=storage)
    ft2 = ts.streambrick_encode(TCFG, T(table), T(x), tile=256,
                                storage_dtype=storage)
    # corner values O(0.1); f32 sums in another order (see
    # test_torch_brick.ENC_ATOL for XLA's CPU dot error)
    np.testing.assert_allclose(N(ft), N(fj), rtol=1e-5, atol=1e-5)
    # the feature-only encode runs the same plan without the jacobian
    np.testing.assert_allclose(N(ft2), N(fj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(N(jt), N(jj), rtol=1e-5, atol=1e-3)
    if stream == "random":
        assert (N(ft) == 0).any()         # overflowed cells are zeroed
