"""Port parity of the Instant-NGP++ model features at the model level,
ingp_tpu_torch against ingp_tpu on CPU: the heads' parameters (skybox,
tonemappers, the appearance block of rgb_net) drawn as JAX draws them,
rgb_net with an appearance embedding, the skybox, the HDR tonemapper,
the row-major forward wrappers with a per-sample exposure, the transient
mask and its table layout, `axisangle_to_R`, `ops/ref_util.py`, and
`test_item`'s depth and exposure. The training step and the test render
with the features on are in test_torch_train_features.py.

Tolerances (measured values in brackets):
- parameter draws bitwise equal;
- f32 forward outputs to rtol 1e-5 (+1e-6 absolute) [1.9e-6 relative];
- bf16 rgb_net / skybox outputs to rtol 2e-2, atol 2e-3, as
  test_torch_model.py's bf16 forward: a sum next to a bf16 rounding
  boundary can round the other way on one side [1.3e-7 relative: no
  value crossed one here];
- f32 gradients of the heads' and the mask's parameters to 1e-5 of each
  leaf's largest |value| [3.8e-7];
- the row-major forward to test_torch_model.py's rtol 1e-4, atol 1e-5
  [normals_raw 5.7e-6 of its largest value: it normalises a short
  density gradient, which XLA's CPU reduce puts ~1e-6 from float64;
  the other outputs 2.1e-7];
- axisangle_to_R to rtol 1e-5, atol 1e-6 [3.4e-6 relative], its
  gradient to rtol 1e-4, atol 1e-5;
- the integrated directional encoding as its test states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ingp_tpu.core.rays import axisangle_to_R as j_axisangle
from ingp_tpu.data.synthetic import SyntheticDataset as JData
from ingp_tpu.models import implicit_mask as jmask
from ingp_tpu.models import ngp as jngp
from ingp_tpu.ops import ref_util as jref
from ingp_tpu.ops.sh import sh_encode_cm as j_sh

from ingp_tpu_torch.core import prng
from ingp_tpu_torch.core.rays import axisangle_to_R as t_axisangle
from ingp_tpu_torch.data.synthetic import SyntheticDataset
from ingp_tpu_torch.models import implicit_mask as tmask
from ingp_tpu_torch.models import ngp as tngp
from ingp_tpu_torch.ops import ref_util as tref
from tests._torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-3)


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    if torch.is_tensor(a):
        a = a.detach()
    return np.asarray(a)


def cfgs(**kw):
    """(JAX, port) NGPConfig pair at a small size with the features on."""
    base = dict(encoder="brick", density_L=4, rgb_L=4, density_log2T=12,
                rgb_log2T=12, grid_size=32, encode_chunk=4096,
                use_skybox=True, embed_a=True, embed_a_len=8,
                rgb_act="none")
    base.update(kw)
    return jngp.NGPConfig(**base), tngp.NGPConfig(**base)


def jax_params(cfg, seed=0):
    p = jax.tree.map(N, jngp.ngp_init(jax.random.PRNGKey(seed), cfg))
    p["density_table"] = p["density_table"] * 1e3
    p["rgb_table"] = p["rgb_table"] * 1e3
    return p


def _leaves_close(got, ref, frac, what):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(ref)):
        a, b = N(a), N(b)
        assert a.shape == b.shape, (what, path)
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= frac * scale, (what, path)


def _grads_port(params, fn):
    """{leaf name: grad} of fn(params) (a scalar) w.r.t. the port's
    params tree."""
    leaves = jax.tree.leaves(params)
    for t in leaves:
        t.requires_grad_()
    gs = torch.autograd.grad(fn(params), leaves, allow_unused=True)
    return jax.tree.unflatten(
        jax.tree.structure(params),
        [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, gs)])


# ------------------------------------------------------------ the draws

@pytest.mark.parametrize("encoder", ["brick", "hash"])
@pytest.mark.parametrize("rgb_act", ["sigmoid", "none"])
def test_ngp_init_features_match(encoder, rgb_act):
    """skybox_net from keys[6], the tonemappers from keys[7..9] and
    rgb_net's appearance rows, equal to JAX's draws from the same key."""
    jc, tc = cfgs(encoder=encoder, rgb_act=rgb_act)
    ref = jax.tree.map(N, jngp.ngp_init(jax.random.PRNGKey(3), jc))
    mine = tngp.params_to_numpy(tngp.ngp_init(tc, prng.prng_key(3)), tc)
    assert set(mine) == set(ref)
    assert ("tonemapper_g" in mine) == (rgb_act == "none")
    assert mine["rgb_net"][0]["w"].shape[0] == 16 + 4 * 8 + 8
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- the heads

@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_act", ["sigmoid", "none"])
def test_rgb_net_with_embedding_matches(cd, out_act):
    jc, tc = cfgs(compute_dtype=cd)
    p = jax_params(jc)
    rng = np.random.default_rng(1)
    n = 300
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    dsh = N(j_sh(d, 4))
    feat = rng.normal(0, 0.3, (n, 32)).astype(np.float32)
    emb = rng.normal(0, 0.5, (n, 8)).astype(np.float32)
    ref = jngp._rgb_net_cm(jc, p, dsh, feat, emb, out_act)
    tp = tngp.params_from_numpy(p)
    got = tngp._rgb_net_cm(tc, tp, T(dsh), T(feat), T(emb), out_act)
    np.testing.assert_allclose(N(got), N(ref), **(F32 if cd == "float32"
                                                   else BF16))
    # the embedding moves the output
    ref0 = jngp._rgb_net_cm(jc, p, dsh, feat, 0 * emb, out_act)
    assert np.abs(N(ref) - N(ref0)).max() > 1e-3
    if cd == "float32":
        w = rng.normal(size=(3, n)).astype(np.float32)
        gj = jax.grad(lambda q, e: jnp.sum(
            jngp._rgb_net_cm(jc, q, dsh, feat, e, out_act) * w),
            argnums=(0, 1))(p, emb)
        et = T(emb).requires_grad_()
        g = _grads_port(tp, lambda q: (tngp._rgb_net_cm(
            tc, q, T(dsh), T(feat), et, out_act) * T(w)).sum())
        _leaves_close(g["rgb_net"], gj[0]["rgb_net"], 1e-5, "rgb_net")
        ge, = torch.autograd.grad((tngp._rgb_net_cm(
            tc, tp, T(dsh), T(feat), et, out_act) * T(w)).sum(), et)
        _leaves_close(ge, gj[1], 1e-5, "embedding")


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("rgb_act", ["sigmoid", "none"])
def test_skybox_matches(cd, rgb_act):
    jc, tc = cfgs(compute_dtype=cd, rgb_act=rgb_act)
    p = jax_params(jc)
    d = np.random.default_rng(2).normal(size=(200, 3)).astype(np.float32)
    ref = jngp.ngp_forward_skybox(jc, p, d)
    tp = tngp.params_from_numpy(p)
    got = tngp.ngp_forward_skybox(tc, tp, T(d))
    assert tuple(got.shape) == (200, 3)
    np.testing.assert_allclose(N(got), N(ref),
                               **(F32 if cd == "float32" else BF16))
    if cd == "float32":
        gj = jax.grad(lambda q: jnp.sum(
            jngp.ngp_forward_skybox(jc, q, d) ** 2))(p)
        g = _grads_port(tp, lambda q: (tngp.ngp_forward_skybox(
            tc, q, T(d)) ** 2).sum())
        _leaves_close(g["skybox_net"], gj["skybox_net"], 1e-5, "skybox")


@pytest.mark.parametrize("exposure", ["none", "per sample", "one"])
def test_log_radiance_to_rgb_matches(exposure):
    jc, tc = cfgs()
    p = jax_params(jc)
    rng = np.random.default_rng(3)
    lr = rng.normal(0, 1.5, (150, 3)).astype(np.float32)
    ex = {"none": None,
          "per sample": rng.uniform(0.1, 4, (150, 1)).astype(np.float32),
          "one": np.ones((1, 1), np.float32)}[exposure]
    ref = jngp.log_radiance_to_rgb(jc, p, lr, ex)
    tp = tngp.params_from_numpy(p)
    got = tngp.log_radiance_to_rgb(tc, tp, T(lr),
                                   None if ex is None else T(ex))
    np.testing.assert_allclose(N(got), N(ref), **F32)
    gj = jax.grad(lambda q: jnp.sum(
        jngp.log_radiance_to_rgb(jc, q, lr, ex) ** 2))(p)
    g = _grads_port(tp, lambda q: (tngp.log_radiance_to_rgb(
        tc, q, T(lr), None if ex is None else T(ex)) ** 2).sum())
    for ch in "rgb":
        _leaves_close(g[f"tonemapper_{ch}"], gj[f"tonemapper_{ch}"], 1e-5,
                      ch)


@pytest.mark.parametrize("encoder", ["brick", "hash"])
def test_ngp_forward_row_major_matches(encoder):
    """ngp_forward with embeddings and a per-sample exposure (tonemapped)
    and with output_radiance; ngp_grad, ngp_density and ngp_rgb_feat
    (tests/test_ngp_model.py:51-90 on the JAX side)."""
    jc, tc = cfgs(encoder=encoder)
    p = jax_params(jc)
    tp = tngp.params_from_numpy(p, cfg=tc)
    rng = np.random.default_rng(4)
    n = 256
    x = rng.uniform(-0.45, 0.45, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    emb = rng.normal(0, 0.5, (n, 8)).astype(np.float32)
    ex = rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    tol = dict(rtol=1e-4, atol=1e-5)
    names = ("sigmas", "rgbs", "normals_raw", "normals_pred", "semantic")
    for kw in (dict(exposure=ex), dict(output_radiance=True)):
        ref = jngp.ngp_forward(jc, p, x, d, embedding_a=emb, **kw)
        got = tngp.ngp_forward(tc, tp, T(x), T(d), embedding_a=T(emb),
                               **{k: T(v) if isinstance(v, np.ndarray)
                                  else v for k, v in kw.items()})
        for name, a, b in zip(names, got, ref):
            assert tuple(a.shape) == b.shape, name
            np.testing.assert_allclose(N(a), N(b), err_msg=name, **tol)
        if "exposure" in kw:
            assert ((N(got[1]) >= 0) & (N(got[1]) <= 1)).all()
        else:
            assert (N(got[1]) > 0).all()
    for a, b in zip(tngp.ngp_grad(tc, tp, T(x)), jngp.ngp_grad(jc, p, x)):
        np.testing.assert_allclose(N(a), N(b), **tol)
    sj, fj = jngp.ngp_density(jc, p, x, return_feat=True)
    st, ft = tngp.ngp_density(tc, tp, T(x), return_feat=True)
    np.testing.assert_allclose(N(st), N(sj), **tol)
    np.testing.assert_allclose(N(ft), N(fj), **tol)
    np.testing.assert_allclose(N(tngp.ngp_rgb_feat(tc, tp, T(x))), N(fj),
                               **tol)
    np.testing.assert_allclose(N(tngp.ngp_density(tc, tp, T(x))), N(sj),
                               **tol)


def test_only_fused_is_refused():
    """Every encoder initialises with the features, the fused one too
    (its one grid table in place of the two); an unknown encoder is
    refused."""
    for enc in ("brick", "fused"):
        for kw in (dict(use_skybox=True), dict(embed_a=True),
                   dict(rgb_act="none")):
            p = tngp.ngp_init(tngp.NGPConfig(density_L=2, rgb_L=2,
                                             density_log2T=10, rgb_log2T=10,
                                             encoder=enc, **kw),
                              prng.prng_key(0))
            assert ("grid_table" in p) == (enc == "fused")
    with pytest.raises(ValueError, match="encoder"):
        tngp.ngp_init(tngp.NGPConfig(encoder="other"), prng.prng_key(0))


# ------------------------------------------------------------- the mask

def test_mask_matches():
    """mask_init draws JAX's values (the table transposed to the port's
    row-major layout), mask_apply and its gradients agree."""
    assert dataclasses.asdict(tmask.MASK_GRID_CFG) == \
        dataclasses.asdict(jmask.MASK_GRID_CFG)
    ref = jax.tree.map(N, jmask.mask_init(jax.random.PRNGKey(5)))
    mine = tmask.mask_init(prng.prng_key(5))
    assert tuple(mine["table"].shape) == ref["table"].shape[::-1]
    back = tngp.params_to_numpy({"msk": mine})["msk"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    # O(0.1) table values, so that the grid drives the mask
    ref["table"] = ref["table"] * 1e3
    tp = tngp.params_from_numpy({"msk": ref})["msk"]
    rng = np.random.default_rng(6)
    uvi = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    mj = jmask.mask_apply(ref, uvi)
    mt = tmask.mask_apply(tp, T(uvi))
    assert tuple(mt.shape) == (500, 1)
    np.testing.assert_allclose(N(mt), N(mj), **F32)
    w = rng.normal(size=(500, 1)).astype(np.float32)
    gj = jax.grad(lambda q: jnp.sum(jmask.mask_apply(q, uvi) * w))(ref)
    g = _grads_port(tp, lambda q: (tmask.mask_apply(q, T(uvi))
                                   * T(w)).sum())
    g = tngp.params_to_numpy({"msk": g})["msk"]
    _leaves_close(g, gj, 1e-5, "mask")


def test_mask_table_layout_round_trips():
    """The mask's table is transposed once on the way in and once on the
    way out, at any depth of the tree and whatever the encoder."""
    ref = jax.tree.map(N, jmask.mask_init(jax.random.PRNGKey(7)))
    _, hash_cfg = cfgs(encoder="hash")
    for cfg in (None, hash_cfg):
        state = {"params": {"msk": ref}, "opt": {"mu": {"msk": ref}}}
        port = tngp.params_from_numpy(state, cfg=cfg)
        assert tuple(port["opt"]["mu"]["msk"]["table"].shape) == \
            ref["table"].shape[::-1]
        back = tngp.params_to_numpy(port, cfg)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------- small pure utilities

def test_axisangle_to_R_matches():
    rng = np.random.default_rng(8)
    v = np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.7, (9, 3)),
                        [[1e-9, 0, 0]]]).astype(np.float32)
    np.testing.assert_allclose(N(t_axisangle(T(v))), N(j_axisangle(v)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N(t_axisangle(T(v[3]))),
                               N(j_axisangle(v[3])), rtol=1e-5, atol=1e-6)
    Rt = N(t_axisangle(T(v)))
    np.testing.assert_allclose(Rt @ Rt.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), Rt.shape),
                               atol=1e-5)
    # finite gradients, also at v = 0 (pose refinement starts there)
    w = rng.normal(size=(11, 3, 3)).astype(np.float32)
    gj = jax.grad(lambda a: jnp.sum(j_axisangle(a) * w))(v)
    vt = T(v).requires_grad_()
    (t_axisangle(vt) * T(w)).sum().backward()
    assert np.isfinite(N(vt.grad)).all()
    np.testing.assert_allclose(N(vt.grad), N(gj), rtol=1e-4, atol=1e-5)


def test_ref_util_matches():
    rng = np.random.default_rng(9)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    n = rng.normal(size=(64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    np.testing.assert_allclose(N(tref.reflect(T(v), T(n))),
                               N(jref.reflect(v, n)), **F32)
    xyz = rng.normal(size=(64, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    kinv = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    for deg in range(1, 6):
        np.testing.assert_array_equal(tref.get_ml_array(deg),
                                      jref.get_ml_array(deg))
        ref = jref.generate_ide_fn(deg)(xyz, kinv)
        got = tref.generate_ide_fn(deg)(T(xyz), T(kinv))
        assert tuple(got.shape) == ref.shape
        # degree 5 (l up to 16) cancels in f32: JAX lands 3.4e-4 from a
        # float64 evaluation, the port 7.5e-5 (largest value 0.40)
        atol = 1e-5 if deg < 5 else 1e-3
        np.testing.assert_allclose(N(got), N(ref), rtol=1e-5, atol=atol)
        assert np.abs(N(got) - _ide_f64(deg, xyz, kinv)).max() <= \
            (1e-6 if deg < 5 else 2e-4)
    with pytest.raises(ValueError):
        tref.generate_ide_fn(6)


def _ide_f64(deg, xyz, kinv):
    """The integrated directional encoding in float64 numpy."""
    ml = jref.get_ml_array(deg)
    mat = np.zeros((2 ** (deg - 1) + 1, ml.shape[1]))
    for i, (m, l) in enumerate(ml.T):
        for k in range(l - m + 1):
            mat[k, i] = jref.sph_harm_coeff(l, m, k)
    x, y, z = (xyz[:, i:i + 1].astype(np.float64) for i in range(3))
    vmz = np.concatenate([z ** i for i in range(mat.shape[0])], -1)
    vmxy = np.concatenate([(x + 1j * y) ** int(m) for m in ml[0]], -1)
    ide = vmxy * (vmz @ mat) * np.exp(-0.5 * ml[1] * (ml[1] + 1) * kinv)
    return np.concatenate([ide.real, ide.imag], -1)


# ------------------------------------------------------- the dataset

def test_test_item_depth_and_exposure_match():
    """test_item returns the image's depth and its exposure (the first
    pixel's), sample_batch the per-ray ones, as JAX's; the trainer's
    batch keys take uv and exposure."""
    from ingp_tpu.training.trainer import NeRFSystem as JSys
    from ingp_tpu_torch.training.trainer import NeRFSystem as TSys
    jd = JData(split="test", img_size=16, n_test=2)
    td = SyntheticDataset(split="test", img_size=16, n_test=2)
    rng = np.random.default_rng(10)
    depth = rng.uniform(0, 5, td.rays.shape[:2]).astype(np.float32)
    ex = np.broadcast_to(rng.uniform(0.2, 3, (2, 1, 1)),
                         td.rays.shape[:2] + (1,)).astype(np.float32)
    for ds in (jd, td):
        ds.depths_2d = depth
        ds.rays = np.concatenate([ds.rays, ex], -1)
    for i in range(2):
        a, b = td.test_item(i), jd.test_item(i)
        assert set(a) == set(b) >= {"depth", "exposure", "rgb"}
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
        assert float(a["exposure"]) == float(ex[i, 0, 0])
    ba = td.sample_batch(np.random.default_rng(1), 64)
    bb = jd.sample_batch(np.random.default_rng(1), 64)
    assert set(ba) == set(bb)
    for k in bb:
        np.testing.assert_array_equal(ba[k], bb[k], err_msg=k)
    assert set(TSys.BATCH_KEYS) == set(JSys.BATCH_KEYS) - {"noise"}
