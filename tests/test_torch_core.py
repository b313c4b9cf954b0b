"""Port parity: core geometry, synthetic data, occupancy bits, march and
compaction (ingp_tpu_torch vs ingp_tpu on the same numpy inputs, CPU)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ingp_tpu.core import cascade as jcas
from ingp_tpu.core.intersect import ray_aabb_intersect as j_aabb
from ingp_tpu.core.morton import morton3d as j_morton, \
    morton3d_invert as j_morton_inv
from ingp_tpu.core.rays import get_ray_directions as j_dirs, \
    get_rays as j_rays
from ingp_tpu.data.synthetic import SyntheticDataset as JSynth
from ingp_tpu.grid.occupancy import grid_init as j_grid_init
from ingp_tpu.models.rendering import clamp_near as j_clamp_near
from ingp_tpu.ops import march as jm
from ingp_tpu.ops import pack as jp

from ingp_tpu_torch.core import cascade as tcas
from ingp_tpu_torch.core.intersect import ray_aabb_intersect as t_aabb
from ingp_tpu_torch.core.morton import morton3d as t_morton, \
    morton3d_invert as t_morton_inv
from ingp_tpu_torch.core.rays import get_ray_directions as t_dirs, \
    get_rays as t_rays
from ingp_tpu_torch.data.synthetic import SyntheticDataset as TSynth, \
    sphere_density_grid
from ingp_tpu_torch.device import resolve_device
from ingp_tpu_torch.grid.occupancy import grid_from_density, \
    grid_init as t_grid_init
from ingp_tpu_torch.models.rendering import clamp_near as t_clamp_near
from ingp_tpu_torch.ops import march as tm
from ingp_tpu_torch.ops import pack as tp


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return np.asarray(a)


def u32_as_i32(a):
    return np.asarray(a).astype(np.uint32).view(np.int32)


def rays(seed, n, inside=False):
    rng = np.random.default_rng(seed)
    if inside:
        o = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    else:
        d0 = rng.normal(size=(n, 3))
        o = (1.3 * d0 / np.linalg.norm(d0, axis=1, keepdims=True)
             ).astype(np.float32)
    tgt = rng.uniform(-0.3, 0.3, (n, 3))
    d = (tgt - o)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def test_resolve_device():
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()


def test_ray_directions_and_rays_match():
    K = np.float32([[20.0, 0, 8], [0, 21.0, 7.5], [0, 0, 1]])
    dj, dt = j_dirs(15, 16, K), t_dirs(15, 16, K)
    np.testing.assert_array_equal(dj, dt)
    rng = np.random.default_rng(0)
    c2w = rng.normal(size=(3, 4)).astype(np.float32)
    oj, rj = j_rays(dj, c2w)
    ot, rt = t_rays(T(dt), T(c2w))
    # f32 matmul of 3-vectors: summation order may differ by an ulp
    np.testing.assert_allclose(N(ot), N(oj), rtol=0, atol=0)
    np.testing.assert_allclose(N(rt), N(rj), rtol=1e-6, atol=1e-6)
    c2ws = rng.normal(size=(dj.shape[0], 3, 4)).astype(np.float32)
    oj, rj = j_rays(dj, c2ws)
    ot, rt = t_rays(T(dt), T(c2ws))
    np.testing.assert_allclose(N(rt), N(rj), rtol=1e-6, atol=1e-6)


def test_aabb_and_clamp_near_match():
    o, d = rays(1, 512)
    o[:40] = o[:40] * 0.01          # some rays start inside the box
    d[40:80] = -d[40:80]            # and some point away
    hj = j_clamp_near(j_aabb(o, d, jnp.zeros(3), jnp.full((3,), 0.5)))
    ht = t_clamp_near(t_aabb(T(o), T(d), torch.zeros(3),
                             torch.full((3,), 0.5)))
    np.testing.assert_array_equal(N(ht), N(hj))
    assert (N(ht)[:, 0] < 0).any() and (N(ht)[:, 0] > 0).any()


def test_cascade_helpers_match():
    rng = np.random.default_rng(2)
    x = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    t = rng.uniform(0, 3, 300).astype(np.float32)
    for scale in (0.5, 1.0, 4.0):
        C = jcas.n_cascades(scale)
        assert tcas.n_cascades(scale) == C
        dtj = jcas.calc_dt(t, 1 / 256, 1024, 64, scale)
        dtt = tcas.calc_dt(T(t), 1 / 256, 1024, 64, scale)
        np.testing.assert_array_equal(N(dtt), N(dtj))
        mj = jnp.maximum(jcas.mip_from_pos(x, C),
                         jcas.mip_from_dt(dtj, 64, C))
        mt = torch.maximum(tcas.mip_from_pos(T(x), C),
                           tcas.mip_from_dt(dtt, 64, C))
        np.testing.assert_array_equal(N(mt), N(mj))
        cj, bj = jcas.cell_coord(x, mj, 64, scale)
        ct, bt = tcas.cell_coord(T(x), mt, 64, scale)
        np.testing.assert_array_equal(N(ct), N(cj))
        np.testing.assert_array_equal(N(bt), N(bj))
        np.testing.assert_array_equal(N(tcas.cell_index(ct, mt, 64)),
                                      N(jcas.cell_index(cj, mj, 64)))


def test_morton_matches():
    rng = np.random.default_rng(3)
    c = rng.integers(0, 1024, (500, 3)).astype(np.int32)
    mj = j_morton(c)
    mt = t_morton(T(c))
    np.testing.assert_array_equal(N(mt), N(mj))
    np.testing.assert_array_equal(N(t_morton_inv(mt)), N(j_morton_inv(mj)))


def test_synthetic_dataset_matches():
    for split in ("train", "test"):
        dj = JSynth(split=split, img_size=24, n_train=3, n_test=2)
        dt = TSynth(split=split, img_size=24, n_train=3, n_test=2)
        for k in ("K", "directions", "poses", "rays", "labels", "normals"):
            np.testing.assert_array_equal(getattr(dt, k), getattr(dj, k))
        assert dt.img_wh == dj.img_wh
        assert dt.test_item(1)["pose"].shape == (3, 4)


def test_grid_init_and_packbits_match():
    gj = j_grid_init(2, 16)
    gt = t_grid_init(2, 16, "cpu")
    for k in gj:
        assert tuple(gt[k].shape) == gj[k].shape
    rng = np.random.default_rng(4)
    dg = rng.uniform(0, 1, 2 * 16 ** 3).astype(np.float32)
    bj = jp.packbits_u32(dg, 0.5)
    bt = tp.packbits_u32(T(dg), 0.5)
    np.testing.assert_array_equal(N(bt), u32_as_i32(bj))
    idx = rng.integers(0, dg.size, 1000).astype(np.int32)
    np.testing.assert_array_equal(N(tp.bitfield_lookup(bt, T(idx))),
                                  N(jp.bitfield_lookup(bj, idx)))
    np.testing.assert_array_equal(N(tp.bitfield_lookup(bt, T(idx))),
                                  dg[idx] > 0.5)


def _scene_grid(gs, C, scale):
    dg = sphere_density_grid(gs, C, scale)
    bj = jp.packbits_u32(dg.reshape(-1), 0.5)
    gt = grid_from_density(t_grid_init(C, gs, "cpu"), T(dg), 0.5, gs, C)
    return dg, bj, gt


def test_block_table_matches():
    # two cascades; the single-cascade grid-32 table is held in
    # test_march_lattice_and_block_match through the block march
    gs, C, scale = 16, 2, 1.0
    _, bj, gt = _scene_grid(gs, C, scale)
    np.testing.assert_array_equal(N(gt["bitfield"]), u32_as_i32(bj))
    tj = jm.build_block_table(bj, gs, C)
    np.testing.assert_array_equal(N(gt["block_table"]), u32_as_i32(tj))


def _march_inputs(n, scale, seed):
    o, d = rays(seed, n)
    hj = j_clamp_near(j_aabb(o, d, jnp.zeros(3), jnp.full((3,), scale)))
    noise = np.random.default_rng(seed).uniform(0, 1, n).astype(np.float32)
    return o, d, N(hj), noise


def _assert_march_equal(mt, mj):
    vt, vj = N(mt["valid"]), N(mj["valid"])
    # the lattice is float32 in both; an FMA contraction on one side can
    # move a sample across a cell boundary. Hold such cells to 1e-4 of
    # the samples (none are seen at these sizes).
    diff = int((vt != vj).sum())
    assert diff <= 1e-4 * vt.size, diff
    both = vt & vj
    # the exp-stepped lattice goes through exp/log, whose float32 results
    # differ by an ulp between XLA and PyTorch: hold t and dt to 1e-6
    np.testing.assert_allclose(N(mt["ts"])[both], N(mj["ts"])[both],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(N(mt["deltas"])[both],
                               N(mj["deltas"])[both], rtol=1e-6, atol=0)
    assert abs(int(mt["total_samples"]) - int(mj["total_samples"])) <= diff


@pytest.mark.parametrize("exp_step", [0.0, 1.0 / 256])
def test_march_lattice_and_block_match(exp_step):
    gs, C, scale = 32, 1, 0.5
    _, bj, gt = _scene_grid(gs, C, scale)
    cfg_j = jm.MarchConfig(grid_size=gs, cascades=C, scale=scale,
                           exp_step_factor=exp_step, capacity=24,
                           iters=256)
    cfg_t = tm.MarchConfig(**{f: getattr(cfg_j, f) for f in
                              ("grid_size", "cascades", "scale",
                               "exp_step_factor", "max_samples",
                               "capacity", "iters")})
    o, d, h, noise = _march_inputs(256, scale, 5)
    mj = jm.march_rays_lattice(cfg_j, bj, o, d, h, noise)
    mt = tm.march_rays_lattice(cfg_t, gt["bitfield"], T(o), T(d), T(h),
                               T(noise))
    _assert_march_equal(mt, mj)
    assert int(mt["total_samples"]) > 0
    tj = jm.build_block_table(bj, gs, C)
    np.testing.assert_array_equal(N(gt["block_table"]), u32_as_i32(tj))
    bmj = jm.march_rays_block(cfg_j, tj, o, d, h, noise)
    bmt = tm.march_rays_block(cfg_t, gt["block_table"], T(o), T(d), T(h),
                              T(noise))
    _assert_march_equal(bmt, bmj)


@pytest.mark.parametrize("K", [10_000, 150])
def test_compaction_matches(K):
    rng = np.random.default_rng(6)
    R, S = 40, 12
    n = rng.integers(0, S + 1, R)
    valid = np.arange(S)[None, :] < n[:, None]
    pj = jp.compact_samples(valid, K)
    pt = tp.compact_samples(T(valid), K)
    for f in pj._fields:
        np.testing.assert_array_equal(N(getattr(pt, f)), N(getattr(pj, f)))
    np.testing.assert_array_equal(N(tp.ray_ids_for(pt)),
                                  N(jp.ray_ids_for(pj)))
    arr = rng.normal(size=(R, S)).astype(np.float32)
    gj = jp.gather_samples(arr, pj)
    gtt = tp.gather_samples(T(arr), pt)
    np.testing.assert_array_equal(N(gtt), N(gj))
    np.testing.assert_array_equal(N(tp.scatter_back(gtt, pt)),
                                  N(jp.scatter_back(gj, pj)))
    arr3 = rng.normal(size=(3, R, S)).astype(np.float32)
    gj3 = jp.gather_samples_cm(arr3, pj)
    gt3 = tp.gather_samples_cm(T(arr3), pt)
    np.testing.assert_array_equal(N(gt3), N(gj3))
    np.testing.assert_array_equal(N(tp.scatter_back_cm(gt3, pt)),
                                  N(jp.scatter_back_cm(gj3, pj)))
