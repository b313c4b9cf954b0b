"""Port parity: SH encoding, activations, MLPs, the NGP model on the
brick encoder and kernel K3 (the volume composite) against ingp_tpu,
on CPU."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ingp_tpu.models import mlp as jmlp
from ingp_tpu.models import ngp as jngp
from ingp_tpu.ops import composite as jcomp
from ingp_tpu.ops import streambrick as js
from ingp_tpu.ops.activations import trunc_exp as j_trunc_exp
from ingp_tpu.ops.pallas.composite_pallas import composite_pallas
from ingp_tpu.ops.sh import sh_encode_cm as j_sh

from ingp_tpu_torch.core import prng
from ingp_tpu_torch.kernels import composite as k3
from ingp_tpu_torch.models import mlp as tmlp
from ingp_tpu_torch.models import ngp as tngp
from ingp_tpu_torch.ops import composite as tcomp
from ingp_tpu_torch.ops.activations import trunc_exp as t_trunc_exp
from ingp_tpu_torch.ops.sh import sh_encode_cm as t_sh


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return np.asarray(a)


def test_sh_and_trunc_exp_match():
    d = np.random.default_rng(0).normal(size=(3, 50)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    for deg in (1, 2, 3, 4):
        np.testing.assert_allclose(N(t_sh(T(d), deg)), N(j_sh(d, deg)),
                                   rtol=1e-6, atol=1e-7)
    x = np.linspace(-10, 10, 41).astype(np.float32)
    xt = T(x).requires_grad_()
    t_trunc_exp(xt).sum().backward()
    gj = jax.grad(lambda v: jnp.sum(j_trunc_exp(v)))(x)
    np.testing.assert_allclose(N(xt.grad), N(gj), rtol=1e-6)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_mlp_apply_cm_matches(cd):
    layers = jmlp.mlp_init(jax.random.PRNGKey(0), (24, 32, 5))
    x = np.random.default_rng(1).normal(size=(70, 24)).astype(np.float32)
    tl = tngp.params_from_numpy(jax.tree.map(N, layers))
    for ha, oa in (("relu", "none"), ("softplus", "sigmoid")):
        oj = jmlp.mlp_apply_cm(layers, x, ha, oa, jnp.dtype(cd))
        ot = tmlp.mlp_apply_cm(tl, T(x), ha, oa,
                               getattr(torch, cd))
        np.testing.assert_allclose(N(ot), N(oj), rtol=1e-5, atol=1e-5)


def small_cfg(**kw):
    base = dict(encoder="brick", density_L=4, rgb_L=4, density_log2T=12,
                rgb_log2T=12, grid_size=32, stream_dedup=True,
                encode_chunk=4096)
    base.update(kw)
    return jngp.NGPConfig(**base), tngp.NGPConfig(**base)


def jax_params(cfg, seed=0):
    p = jax.tree.map(N, jngp.ngp_init(jax.random.PRNGKey(seed), cfg))
    # O(0.1) table values so that the features, not the biases, drive
    # the heads
    p["density_table"] = p["density_table"] * 1e3
    p["rgb_table"] = p["rgb_table"] * 1e3
    return p


def test_params_roundtrip_and_init_shapes():
    jc, tc = small_cfg()
    p = jax_params(jc)
    back = tngp.params_to_numpy(tngp.params_from_numpy(p))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)
    mine = tngp.ngp_init(tc, prng.prng_key(0), "cpu")
    assert jax.tree.structure(tngp.params_to_numpy(mine)) == \
        jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(tngp.params_to_numpy(mine)),
                    jax.tree.leaves(p)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # the same key draws the JAX package's values
    ref = jngp.ngp_init(jax.random.PRNGKey(0), jc)
    for a, b in zip(jax.tree.leaves(tngp.params_to_numpy(mine)),
                    jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert dataclasses.asdict(tc.density_brick_cfg) == \
        dataclasses.asdict(jc.density_brick_cfg)


def _points(seed, n_rays=40):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.arange(24)[None, :, None] * (np.sqrt(3) / 1024)
    x = np.clip(o[:, None] + t * d[:, None], -0.5, 0.5).reshape(-1, 3)
    dirs = np.repeat(d, 24, 0)
    return x.T.astype(np.float32), dirs.T.astype(np.float32)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_ngp_forward_matches(monkeypatch, precision):
    if precision == "f32":
        jc, tc = small_cfg()
        tol = dict(rtol=1e-4, atol=1e-5)
    else:
        jc, tc = small_cfg(compute_dtype="bfloat16",
                           table_dtype="bfloat16")
        # bf16 MLP operands: products are exact and sums f32 on both
        # sides, but a sum that lands next to a bf16 rounding boundary
        # can round to the neighbouring bf16 value on one side
        tol = dict(rtol=2e-2, atol=2e-3)
    p = jax_params(jc)
    tp = tngp.params_from_numpy(p)
    x, d = _points(3)
    monkeypatch.setenv("INGP_STREAM_GROUPED", "1")
    monkeypatch.setenv("INGP_STREAM_GROUPED_INTERPRET", "1")
    js.streambrick_encode.clear_cache()
    js.streambrick_encode_grad.clear_cache()
    try:
        for stream in (False, True):
            sj = jngp.ngp_sigma_cm(jc, p, x, stream=stream)
            st = tngp.ngp_sigma_cm(tc, tp, T(x), stream=stream)
            np.testing.assert_allclose(N(st), N(sj), **tol)
        outs_j = jngp.ngp_forward_cm(jc, p, x, d, stop_header_grads=True,
                                     stream=True)
    finally:
        js.streambrick_encode.clear_cache()
        js.streambrick_encode_grad.clear_cache()
    outs_t = tngp.ngp_forward_cm(tc, tp, T(x), T(d), stream=True)
    names = ("sigmas", "rgbs", "normals_raw", "normals_pred", "semantic")
    for name, a, b in zip(names, outs_t, outs_j):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(N(a), N(b), err_msg=name, **tol)


def _composite_inputs(seed, R, S, C=0):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, S + 1, R)
    valid = np.arange(S)[None] < n[:, None]
    sig = rng.uniform(0, 40, (R, S)).astype(np.float32)
    dt = np.full((R, S), np.sqrt(3) / 1024 * 8, np.float32)
    ts = (np.cumsum(dt, 1) + 0.3).astype(np.float32)
    rgbs = rng.uniform(0, 1, (3, R, S)).astype(np.float32)
    aux = rng.normal(size=(C, R, S)).astype(np.float32)
    return sig, dt, ts, valid, rgbs, aux


@pytest.mark.parametrize("thr", [1e-4, 1e-2])
def test_k3_plain_matches_pallas_interpret(thr):
    sig, dt, ts, valid, rgbs, _ = _composite_inputs(4, 16, 48)
    wj, oj, dj, cj = composite_pallas(sig, rgbs, dt, ts, valid, thr, True)
    out = k3.composite(T(sig), T(dt), T(ts), T(valid), thr, rgbs=T(rgbs))
    # exp of float32 cumsums taken in another order: a few ulps
    for a, b in ((out["ws"], wj), (out["opacity"], oj),
                 (out["depth"], dj), (out["rgb"], cj)):
        np.testing.assert_allclose(N(a), N(b), rtol=1e-5, atol=1e-6)
    assert (N(out["ws"])[~valid] == 0).all()


def test_composite_rays_and_render_weights_match():
    sig, dt, ts, valid, rgbs, aux = _composite_inputs(5, 33, 20, C=13)
    thr = 1e-2
    wj, Tj = jcomp.render_weights(sig, dt, valid, thr)
    wt, Tt = tcomp.render_weights(T(sig), T(dt), T(valid), thr)
    np.testing.assert_allclose(N(wt), N(wj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N(Tt), N(Tj), rtol=1e-5, atol=1e-6)
    rj = jcomp.composite_rays(sig, rgbs, dt, ts, valid, thr,
                              normals_pred=aux[:3], normals_raw=aux[3:6],
                              sems=aux[6:])
    rt = tcomp.composite_rays(T(sig), T(rgbs), T(dt), T(ts), T(valid), thr,
                              normals_pred=T(aux[:3]),
                              normals_raw=T(aux[3:6]), sems=T(aux[6:]))
    assert set(rt) == set(rj)
    for k in rj:
        np.testing.assert_allclose(N(rt[k]), N(rj[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_k3_wrapper_rejects_other_devices():
    sig, dt, ts, valid, _, _ = _composite_inputs(6, 4, 8)
    with pytest.raises(ValueError):
        k3.composite(T(sig).to("meta"), T(dt), T(ts), T(valid), 1e-2)
