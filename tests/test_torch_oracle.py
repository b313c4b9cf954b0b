"""Port parity of the render layer's oracles and small leftovers against
ingp_tpu on CPU: ray_sphere_intersect and composite_alpha (to float32
rounding), the exact-skip march_rays (ts, deltas and valid equal), the
dense oracle renderer on the same prng draws (stratified_z to rtol 1e-6,
sample_pdf to rtol 1e-5, render_rays_oracle to the render bounds of
test_torch_train_render.py), FrameEmbedding (exact) and
resize_area against cv2's INTER_AREA (1e-5)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ingp_tpu.core import intersect as jint
from ingp_tpu.models import ngp as jngp
from ingp_tpu.models import oracle as jor
from ingp_tpu.ops import composite as jcomp
from ingp_tpu.ops import pack as jp
from ingp_tpu.ops import march as jmarch
from ingp_tpu.utils.frame_embedding import FrameEmbedding as JFrameEmb

from ingp_tpu_torch.core import intersect as tint
from ingp_tpu_torch.core import prng
from ingp_tpu_torch.data.image_io import resize_area
from ingp_tpu_torch.models import ngp as tngp
from ingp_tpu_torch.models import oracle as tor
from ingp_tpu_torch.models import rendering as trend
from ingp_tpu_torch.ops import composite as tcomp
from ingp_tpu_torch.ops import march as tmarch
from ingp_tpu_torch.utils.frame_embedding import FrameEmbedding
from tests._torch_threads import one_torch_thread  # noqa: F401


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    if torch.is_tensor(a):
        a = a.detach()
    return np.asarray(a)


def _rays(rng, R, z0):
    ro = np.stack([rng.uniform(-0.3, 0.3, R), rng.uniform(-0.3, 0.3, R),
                   np.full(R, z0)], -1).astype(np.float32)
    rd = np.stack([rng.uniform(-0.2, 0.2, R), rng.uniform(-0.2, 0.2, R),
                   np.ones(R)], -1).astype(np.float32)
    return ro, rd


def test_ray_sphere_intersect_matches():
    rng = np.random.default_rng(0)
    ro = rng.normal(size=(200, 3)).astype(np.float32)
    rd = rng.normal(size=(200, 3)).astype(np.float32)
    center = np.array([0.1, -0.2, 0.3], np.float32)
    ref = N(jint.ray_sphere_intersect(ro, rd, center, 1.2))
    out = N(tint.ray_sphere_intersect(T(ro), T(rd), T(center), 1.2))
    assert ((ref[:, 0] >= 0).sum() > 20) and ((ref[:, 0] == -1).sum() > 20)
    np.testing.assert_array_equal(out == -1, ref == -1)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_composite_alpha_matches():
    rng = np.random.default_rng(1)
    sig = rng.exponential(5.0, (8, 40)).astype(np.float32)
    dt = rng.uniform(0.001, 0.05, (8, 40)).astype(np.float32)
    valid = rng.random((8, 40)) < 0.8
    ref = jcomp.composite_alpha(sig, dt, valid)
    out = tcomp.composite_alpha(T(sig), T(dt), T(valid))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(N(a), N(b), rtol=2e-6, atol=1e-7)


def _occupancy(gs, C, scale, fn):
    """Row-major occupancy words of a predicate on cell centres, the JAX
    package's (uint32) and the port's (int32)."""
    dense = np.zeros((C, gs, gs, gs), bool)
    ax = (np.arange(gs) + 0.5) / gs * 2 - 1
    for c in range(C):
        b = min(2.0 ** (c - 1), scale)
        X, Y, Z = np.meshgrid(ax * b, ax * b, ax * b, indexing="ij")
        dense[c] = np.transpose(fn(X, Y, Z), (2, 1, 0))
    bits = jp.packbits_u32(jnp.asarray(dense.reshape(-1), jnp.float32), 0.5)
    return bits, T(N(bits).view(np.int32))


def _march_scene(kind):
    """(config kwargs, JAX's and the port's occupancy words, rays, their
    box hits, noise) of a constant-step or an exponential-step scene."""
    if kind == "constant":
        kw = dict(grid_size=32, cascades=1, scale=0.5, exp_step_factor=0.0,
                  max_samples=256, capacity=64, iters=256)
        pred = lambda x, y, z: x ** 2 + y ** 2 + z ** 2 < 0.25 ** 2
        z0 = -2.0
    else:
        kw = dict(grid_size=32, cascades=2, scale=1.0,
                  exp_step_factor=1 / 64, max_samples=512, capacity=48,
                  iters=384)
        pred = lambda x, y, z: (np.abs(x) < 0.6) & (np.abs(y) < 0.6) \
            & (np.abs(z) < 0.6) & (x + y > -0.3)
        z0 = -3.0
    jbits, tbits = _occupancy(kw["grid_size"], kw["cascades"], kw["scale"],
                              pred)
    rng = np.random.default_rng(2)
    ro, rd = _rays(rng, 48, z0)
    noise = rng.random(48).astype(np.float32)
    hits = N(jint.ray_aabb_intersect(ro, rd, np.zeros(3),
                                     np.full(3, kw["scale"])))
    return kw, jbits, tbits, ro, rd, hits, noise


@pytest.mark.parametrize("kind", ["constant", "exponential"])
def test_march_rays_exact_skip_matches(kind):
    kw, jbits, tbits, ro, rd, hits, noise = _march_scene(kind)
    jc, tc = jmarch.MarchConfig(**kw), tmarch.MarchConfig(**kw)
    ref = jmarch.march_rays(jc, jbits, ro, rd, hits, noise)
    out = tmarch.march_rays(tc, tbits, T(ro), T(rd), T(hits), T(noise))
    assert int(ref["total_samples"]) > 100
    assert int(out["total_samples"]) == int(ref["total_samples"])
    for k in ("ts", "deltas", "valid", "n_samples"):
        np.testing.assert_array_equal(N(out[k]), N(ref[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["constant", "exponential"])
def test_port_marchers_against_exact_skip(kind):
    """The exact-skip march_rays as the oracle of the port's lattice and
    block marchers at a constant step, as
    tests/test_march_composite.py holds the JAX lattice march (at an
    exponential step its skips leave the lattice, and the JAX suite
    holds the marchers to a scalar loop instead): each scene with its
    step made constant, the lattice march keeps the exact march's
    samples (ts and deltas to 1e-5); the block march is the lattice
    march on one cascade and keeps every lattice sample at the same t
    on two (its mip-transition runs are conservative), on rays that
    did not fill their capacity (tests/test_block_march.py)."""
    kw, _, bits, ro, rd, hits, noise = _march_scene(kind)
    cfg = tmarch.MarchConfig(**dict(kw, exp_step_factor=0.0))
    ro, rd, hits, noise = T(ro), T(rd), T(hits), T(noise)
    exact = tmarch.march_rays(cfg, bits, ro, rd, hits, noise)
    lat = tmarch.march_rays_lattice(cfg, bits, ro, rd, hits, noise)
    table = tmarch.build_block_table(bits, cfg.grid_size, cfg.cascades)
    blk = tmarch.march_rays_block(cfg, table, ro, rd, hits, noise)
    assert int(exact["total_samples"]) > 100
    np.testing.assert_array_equal(N(lat["n_samples"]), N(exact["n_samples"]))
    np.testing.assert_allclose(N(lat["ts"]), N(exact["ts"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(N(lat["deltas"]), N(exact["deltas"]),
                               rtol=1e-5)
    if cfg.cascades == 1:
        for k in ("ts", "deltas", "valid"):
            assert torch.equal(blk[k], lat[k]), k
        return
    lat_ts, lat_valid = N(lat["ts"]), N(lat["valid"])
    blk_ts, blk_valid = N(blk["ts"]), N(blk["valid"])
    kept = 0
    for r in range(len(lat_ts)):
        if blk_valid[r].sum() < cfg.capacity:
            want = lat_ts[r][lat_valid[r]]
            assert np.isin(want, blk_ts[r][blk_valid[r]]).all(), r
            kept += len(want)
    assert kept > 0


def test_stratified_z_and_sample_pdf_on_jax_draws():
    key = 7
    t1 = np.array([0.2, 0.5, 1.0, 0.01], np.float32)
    t2 = np.array([1.0, 2.0, 1.5, 0.7], np.float32)
    for perturb in (False, True):
        for warp in (False, True):
            ref = jax.jit(jor.stratified_z, static_argnums=(3, 4, 5))(
                jax.random.PRNGKey(key), t1, t2, 24, perturb, warp)
            out = tor.stratified_z(prng.prng_key(key), T(t1), T(t2), 24,
                                   perturb, warp)
            np.testing.assert_allclose(N(out), N(ref), rtol=1e-6,
                                       atol=1e-7)
    rng = np.random.default_rng(3)
    bins = np.sort(rng.uniform(0, 2, (6, 17)), -1).astype(np.float32)
    w = rng.exponential(1.0, (6, 16)).astype(np.float32)
    for det in (True, False):
        ref = jax.jit(jor.sample_pdf, static_argnums=(3, 4))(
            jax.random.PRNGKey(key), bins, w, 40, det)
        out = tor.sample_pdf(prng.prng_key(key), T(bins), T(w), 40, det)
        np.testing.assert_allclose(N(out), N(ref), rtol=1e-5, atol=1e-6)


def test_render_rays_oracle_on_jax_draws():
    kw = dict(encoder="hash", density_L=2, rgb_L=2, density_log2T=12,
              rgb_log2T=12, grid_size=32, embed_a=True, embed_a_len=4)
    jc, tc = jngp.NGPConfig(**kw), tngp.NGPConfig(**kw)
    # the port's init draws JAX's values (tests/test_torch_prng.py)
    params = tngp.params_to_numpy(tngp.ngp_init(tc, prng.prng_key(0),
                                                device="cpu"), cfg=tc)
    params["density_table"] = params["density_table"] * 1e3
    params["rgb_table"] = params["rgb_table"] * 1e3
    rng = np.random.default_rng(4)
    ro, rd = _rays(rng, 24, -1.5)
    emb = rng.normal(size=(24, 4)).astype(np.float32)
    ref = jor.render_rays_oracle(jc, params, ro, rd, jax.random.PRNGKey(5),
                                 n_samples=32, perturb=True,
                                 embedding_a=emb)
    out = tor.render_rays_oracle(
        tc, tngp.params_from_numpy(params, cfg=tc), T(ro), T(rd),
        prng.prng_key(5), n_samples=32, perturb=True, embedding_a=T(emb))
    assert set(out) == set(ref)
    assert N(ref["opacity"]).max() > 0.05
    np.testing.assert_array_equal(N(out["vr_samples"]), N(ref["vr_samples"]))
    for k in ("ts", "deltas", "ws", "opacity", "depth", "rgb",
              "normal_pred", "normal_raw", "semantic"):
        r = N(ref[k])
        frac = 1e-3 if k == "normal_raw" else 1e-4
        np.testing.assert_allclose(N(out[k]), r, rtol=1e-4,
                                   atol=frac * np.abs(r).max(), err_msg=k)


@pytest.mark.parametrize("marcher", ["block", "lattice"])
def test_render_rays_test_against_dense_oracle(marcher):
    """The dense oracle renderer as the oracle of the port's test render
    (march, sample budget, compaction, composite), as
    tests/test_render.py holds the JAX renderer: a random field on a
    full occupancy grid, room for every sample, within 0.05 (the two
    quadratures differ: the marcher's dt lattice, the oracle's strata)."""
    cfg = tngp.NGPConfig(scale=0.5, density_L=4, density_log2T=12,
                         rgb_L=4, rgb_log2T=12, classes=3, grid_size=32)
    params = tngp.ngp_init(cfg, prng.prng_key(0), device="cpu")
    params["density_table"] = params["density_table"] * 2e3
    bits = torch.full((cfg.cascades * cfg.grid_size ** 3 // 32,), -1,
                      dtype=torch.int32)
    table = tmarch.build_block_table(bits, cfg.grid_size, cfg.cascades) \
        if marcher == "block" else None
    rng = np.random.default_rng(3)
    ro, rd = _rays(rng, 64, -1.4)
    rd[:, :2] *= 0.5
    rcfg = trend.RenderConfig(capacity=1024, march_iters=1104,
                              samples_per_ray=1024, T_threshold=1e-4)
    fast = trend.render_rays_test(cfg, rcfg, params, bits, T(ro), T(rd),
                                  block_table=table)
    oracle = tor.render_rays_oracle(cfg, params, T(ro), T(rd),
                                    prng.prng_key(0), n_samples=1024)
    assert N(oracle["opacity"]).max() > 0.3
    for k in ("opacity", "rgb", "depth"):
        np.testing.assert_allclose(N(fast[k]), N(oracle[k]), rtol=0,
                                   atol=0.05, err_msg=k)


def test_frame_embedding_matches():
    rng = np.random.default_rng(6)
    table = rng.normal(size=(7, 5)).astype(np.float32)
    poses = rng.normal(size=(7, 3, 4)).astype(np.float32)
    jf, tf = JFrameEmb(table, poses), FrameEmbedding(T(table), T(poses))
    for q in rng.normal(size=(4, 3, 4)).astype(np.float32):
        for mode in ("nearest", "mean"):
            np.testing.assert_array_equal(N(tf(q, mode)), jf(q, mode))
    np.testing.assert_array_equal(N(tf(3)), jf(3))
    np.testing.assert_array_equal(N(tf([0, 6])), jf([0, 6]))
    with pytest.raises(ValueError, match="Invalid mode"):
        tf(0, "bogus")


@pytest.mark.parametrize("shape,factor", [((64, 48, 3), 2), ((64, 96, 1), 4),
                                          ((48, 72, 3), 1.5), ((36, 54), 1.5),
                                          ((35, 52, 3), 1.5)])
def test_resize_area_matches_cv2(shape, factor):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(7).random(shape, dtype=np.float32)
    w, h = int(shape[1] / factor), int(shape[0] / factor)
    ref = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    out = resize_area(img, (w, h))
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
