"""Port parity of the parts of the training step around the network:
the training render (render_rays with injected ray jitter) and the
occupancy grid (mark_invisible_cells, the refresh from injected draws),
ingp_tpu_torch against ingp_tpu on CPU. Set-up and tolerances as in
test_torch_train.py; the grid refresh holds densities to rtol 1e-5
(atol 1e-5) and the bitfield and block table exactly."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from ingp_tpu.data.synthetic import SyntheticDataset as JData
from ingp_tpu.grid import occupancy as jocc
from ingp_tpu.models import ngp as jngp
from ingp_tpu.models import rendering as jr
from ingp_tpu.training import trainer as jt

from ingp_tpu_torch.core import prng
from ingp_tpu_torch.grid import occupancy as tocc
from ingp_tpu_torch.models import ngp as tngp
from ingp_tpu_torch.models import rendering as tr

from tests.test_torch_train import N, T, jax_grouped, pair


def test_render_rays_train_matches():
    p = pair("f32")
    b = p.batches[0]
    j = p.jsys
    ro, rd = (N(a) for a in jt.get_rays(j.directions[b["pix_idxs"]],
                                         j.poses[b["img_idxs"]]))
    with jax_grouped():
        ref = jr.render_rays(j.model_cfg, j.render_cfg, p.params["model"],
                             p.bits, ro, rd, b["noise"],
                             block_table=p.table)
        ref = {k: N(v) for k, v in ref.items()}
    out = tr.render_rays(p.psys.model_cfg, p.psys.render_cfg,
                         p.psys.params["model"], p.psys.grid["bitfield"],
                         T(ro), T(rd), T(b["noise"]),
                         block_table=p.psys.grid["block_table"])
    assert set(out) == set(ref)
    assert int(out["total_samples"]) == int(ref["total_samples"]) > 0
    np.testing.assert_array_equal(N(out["vr_samples"]), ref["vr_samples"])
    np.testing.assert_array_equal(N(out["valid"]), ref["valid"])
    assert (ref["opacity"] > 0.05).any()
    for k in ("rgb", "depth", "opacity", "ws", "sigmas", "ts", "deltas",
              "distortion", "Ro", "Rp", "normal_pred", "normal_raw",
              "semantic"):
        scale = np.abs(ref[k]).max()
        # normal_raw normalises the density gradient, whose XLA CPU dot
        # form strays ~1e-5 of the corner scale from float64; where the
        # gradient is short the normalisation amplifies that (measured
        # 1.3e-4 of the largest value here; test_torch_render.py)
        frac = 1e-3 if k == "normal_raw" else 1e-4
        np.testing.assert_allclose(N(out[k]), ref[k], rtol=1e-4,
                                   atol=frac * scale, err_msg=k)


def test_mark_invisible_cells_matches():
    ds = JData(split="train", img_size=24, n_train=4)
    G, C, scale = 32, 2, 1.0
    # two cameras leave cells that no camera sees
    poses = ds.poses[:2]
    gj = jocc.mark_invisible_cells(jocc.grid_init(C, G), ds.K, poses,
                                   24, 24, G, C, scale)
    gt = tocc.mark_invisible_cells(tocc.grid_init(C, G), ds.K, T(poses),
                                   24, 24, G, C, scale)
    np.testing.assert_array_equal(N(gt["density_grid"]),
                                  N(gj["density_grid"]))
    np.testing.assert_allclose(N(gt["count_grid"]), N(gj["count_grid"]),
                               rtol=1e-6)
    assert (N(gj["density_grid"]) == -1).any()


def _jax_draws(key, G, C, warmup):
    """The draws update_density_grid makes from `key`, made with JAX's
    own random functions in its order, as numpy arrays for the port."""
    g3 = G ** 3
    M = g3 // 4
    out = []
    for _ in range(C):
        key, k_cells, k_occ, k_jit = jax.random.split(key, 4)
        d = {}
        n = g3
        if not warmup:
            d["idx_u"] = T(jax.random.randint(k_cells, (M,), 0, g3,
                                              dtype=jnp.int32))
            d["u_occ"] = T(jax.random.uniform(k_occ, (M,)))
            n = 2 * M
        d["jitter"] = T(jax.random.uniform(k_jit, (n, 3), minval=-1.0,
                                           maxval=1.0))
        out.append(d)
    return out


def test_update_density_grid_matches():
    """A warmup sweep, then a sampled refresh on its result, each from
    the draws JAX makes for its key."""
    p = pair("f32")
    cfg = p.jsys.model_cfg
    G, C = cfg.grid_size, cfg.cascades
    thr = 1e-2 * 1024 / np.sqrt(3)
    jparams = jax.tree.map(jnp.asarray, p.params["model"])
    tparams = tngp.params_from_numpy(p.params["model"])
    grid_j = jocc.mark_invisible_cells(jocc.grid_init(C, G), p.tr.K,
                                       p.tr.poses, 24, 24, G, C, cfg.scale)
    grid_t = {k: T(v) for k, v in grid_j.items()}
    grid_t["bitfield"] = grid_t["bitfield"].to(torch.int32)
    grid_t["block_table"] = grid_t["block_table"].to(torch.int32)

    def density_t(x):
        return tngp.ngp_sigma_cm(p.psys.model_cfg, tparams, x.T)

    for i, warmup in enumerate((True, False)):
        key = jax.random.PRNGKey(10 + i)
        grid_j = jocc.update_density_grid(
            lambda prm, x: jngp.ngp_sigma(cfg, prm, x), jparams, grid_j,
            key, thr, G, C, cfg.scale, warmup)
        grid_t = tocc.update_density_grid(
            density_t, grid_t, _jax_draws(key, G, C, warmup), thr, G, C,
            cfg.scale, warmup)
        np.testing.assert_allclose(N(grid_t["density_grid"]),
                                   N(grid_j["density_grid"]), rtol=1e-5,
                                   atol=1e-5)
        # the port's int32 words hold the JAX package's uint32 bits
        np.testing.assert_array_equal(
            grid_t["bitfield"].to(torch.int64).numpy() % (1 << 32),
            np.asarray(grid_j["bitfield"], np.int64))
        np.testing.assert_array_equal(
            grid_t["block_table"].to(torch.int64).numpy() % (1 << 32),
            np.asarray(grid_j["block_table"], np.int64))
        # the sampled refresh keeps some cells and decays the rest
        occ = int(np.unpackbits(np.asarray(grid_j["bitfield"]).view(
            np.uint8)).sum())
        assert 0 < occ < G ** 3


def test_grid_draws_shapes():
    for warmup in (True, False):
        d = tocc.grid_draws(prng.prng_key(3), 8, 2, warmup)
        # the JAX package's draws from the same key
        for mine, ref in zip(d, _jax_draws(jax.random.PRNGKey(3), 8, 2,
                                           warmup)):
            assert set(mine) == set(ref)
            for k in ref:
                assert torch.equal(mine[k], ref[k].to(mine[k].dtype)), k
        assert len(d) == 2
        n = 512 if warmup else 256
        assert d[0]["jitter"].shape == (n, 3)
        assert float(d[0]["jitter"].abs().max()) <= 1.0
        if not warmup:
            assert d[1]["idx_u"].shape == (128,)
            assert int(d[1]["idx_u"].max()) < 512
