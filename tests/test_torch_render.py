"""Port parity of the whole slice: the test render (intersect, block
march, sigma prepass through the stream encoder, visibility cut, full
forward, composite) of ingp_tpu_torch against ingp_tpu's
render_rays_test, on a 16x16 synthetic view with a bitfield marked from
the scene's spheres and the same parameters carried across."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from ingp_tpu.core.rays import get_rays as j_get_rays
from ingp_tpu.models import ngp as jngp
from ingp_tpu.models import rendering as jr
from ingp_tpu.ops import pack as jp
from ingp_tpu.ops import streambrick as js
from ingp_tpu.ops.march import build_block_table
from ingp_tpu.training import trainer as jt

from ingp_tpu_torch.data.synthetic import SyntheticDataset, \
    sphere_density_grid
from ingp_tpu_torch.grid.occupancy import grid_from_density
from ingp_tpu_torch.models import rendering as tr
from ingp_tpu_torch.training import trainer as tt


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return np.asarray(a)


def hparams(**kw):
    h = dict(dataset_name="synthetic", scale=0.5, use_skybox=False,
             use_exposure=False, embed_a=False, embed_a_len=4,
             num_classes=7, random_bg=False, chunk_size=131072,
             compute_dtype="float32", capacity=48, march_iters=1024,
             samples_per_ray=24, encoder="brick", table_dtype="float32",
             encode_chunk=4096, stream_dedup=True, stream_tile=256,
             density_L=4, rgb_L=4, density_log2T=12, rgb_log2T=12,
             grid_size=32)
    h.update(kw)
    return SimpleNamespace(**h)


def _fields(cfg, drop):
    d = dataclasses.asdict(cfg)
    for k in drop:
        d.pop(k, None)
    return d


# JAX-only fields: the port has no remat policy, always composites
# through K3, and leaves the training step's options (sorted-stream
# caps, random background, header-gradient stop, run statistics) to the
# training slice
JAX_ONLY_MODEL = ["encode_remat", "stream_seg_head", "stream_head_frac",
                  "stream_caps"]
JAX_ONLY_RENDER = ["pallas_composite", "random_bg", "stop_header_grads",
                   "run_stats", "stream_sort"]


def test_config_mapping_matches():
    for kw in ({}, dict(dataset_name="colmap", capacity=192)):
        h = hparams(**kw)
        assert dataclasses.asdict(tt.model_config_from_hparams(h)) == \
            _fields(jt.model_config_from_hparams(h), JAX_ONLY_MODEL)
        for test in (False, True):
            assert dataclasses.asdict(
                tt.render_config_from_hparams(h, test)) == \
                _fields(jt.render_config_from_hparams(h, test),
                        JAX_ONLY_RENDER)


def _setup(precision):
    h = hparams() if precision == "f32" else \
        hparams(compute_dtype="bfloat16", table_dtype="bfloat16")
    jm = jt.model_config_from_hparams(h)
    jrc = jt.render_config_from_hparams(h, test=True)
    params = jax.tree.map(N, jngp.ngp_init(jax.random.PRNGKey(0), jm))
    params["density_table"] = params["density_table"] * 1e4
    params["rgb_table"] = params["rgb_table"] * 1e3
    ds = SyntheticDataset(split="test", img_size=16, n_test=1)
    system = tt.NeRFSystem(h, ds, device="cpu", params=params)
    dg = sphere_density_grid(jm.grid_size, jm.cascades, jm.scale)
    system.grid = grid_from_density(system.grid, T(dg), 0.5, jm.grid_size,
                                    jm.cascades)
    bits = jp.packbits_u32(dg.reshape(-1), 0.5)
    table = build_block_table(bits, jm.grid_size, jm.cascades)
    return h, jm, jrc, params, ds, system, bits, table


def _jax_render(monkeypatch, jm, jrc, params, bits, table, ro, rd):
    monkeypatch.setenv("INGP_STREAM_GROUPED", "1")
    monkeypatch.setenv("INGP_STREAM_GROUPED_INTERPRET", "1")
    js.streambrick_encode.clear_cache()
    js.streambrick_encode_grad.clear_cache()
    jr.render_rays_test.clear_cache()
    try:
        out = jr.render_rays_test(jm, jrc, params, bits, ro, rd,
                                  block_table=table)
        return {k: N(v) for k, v in out.items()}
    finally:
        js.streambrick_encode.clear_cache()
        js.streambrick_encode_grad.clear_cache()
        jr.render_rays_test.clear_cache()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_render_rays_test_matches(monkeypatch, precision):
    h, jm, jrc, params, ds, system, bits, table = _setup(precision)
    ro, rd = (N(a) for a in j_get_rays(ds.directions, ds.poses[0]))
    ref = _jax_render(monkeypatch, jm, jrc, params, bits, table, ro, rd)
    out = tr.render_rays_test(system.model_cfg, system.render_cfg_test,
                              system.params, system.grid["bitfield"],
                              T(ro), T(rd),
                              block_table=system.grid["block_table"])
    assert int(out["total_samples"]) == int(ref["total_samples"]) > 0
    assert (ref["opacity"] > 0.05).any()
    # f32: sums in another order through the encoder, MLPs and
    # composite. bf16: a feature that lands next to a bf16 rounding
    # boundary can round the other way and move an MLP output by a
    # bf16 ulp (~0.4%), so outputs are held to 2e-2.
    tol = dict(rtol=1e-4, atol=2e-5) if precision == "f32" else \
        dict(rtol=2e-2, atol=2e-3)
    for k in ("rgb", "depth", "opacity", "normal_pred", "semantic_probs",
              "points"):
        np.testing.assert_allclose(N(out[k]), ref[k], err_msg=k, **tol)
    # normal_raw normalises the density gradient, a sum of +-weighted
    # corner differences over all levels. XLA's CPU dot form of the
    # jacobian strays ~1e-5 of the corner scale from a float64 reference
    # (test_torch_brick.ENC_ATOL), and the normalisation amplifies that
    # where the gradient is short: measured 2.2e-4 (f32) / 2.1e-3 (bf16)
    # on unit normals.
    np.testing.assert_allclose(
        N(out["normal_raw"]), ref["normal_raw"], err_msg="normal_raw",
        rtol=0, atol=1e-3 if precision == "f32" else 1e-2)
    agree = (N(out["semantic"]) == ref["semantic"]).mean()
    assert agree >= (1.0 if precision == "f32" else 0.95), agree


def test_render_image_chunks_like_one_call():
    h, jm, jrc, params, ds, system, bits, table = _setup("f32")
    whole = system.render_image(ds.poses[0])
    chunked = system.render_image(ds.poses[0], chunk_size=100)
    assert whole["total_samples"] == chunked["total_samples"] > 0
    for k in whole:
        if k == "total_samples":
            continue
        assert whole[k].shape[0] == 256
        np.testing.assert_allclose(N(chunked[k]), N(whole[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
