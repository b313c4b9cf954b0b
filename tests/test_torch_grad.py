"""Port parity of the backward kernels' plain versions: K1
(fused_ray_reduce_bwd), K2 (brick_reduce_bwd) and K3 (composite_bwd)
against the JAX custom_vjps of ingp_tpu's Pallas kernels run with
interpret=True, and against JAX AD of the XLA forms (reduce_feats_jac,
composite_rays), on CPU; and the encoders' and composite's autograd
Functions end to end.

The JAX kernels return the cotangent of the gathered row block; the
table's gradient is its f32 scatter-add at the rows (ingp_tpu/ops/
gather.py `_gather_multi_bwd`), which the tests apply. The port's
backward kernels add into the f32 master gradient themselves.

Tolerances: f32 tables at rtol 1e-5, plus an absolute 1e-6 of the
largest |value| for entries that are sums with cancellation (the two
sides add in other orders). bf16 tables: each cell's cotangent (and, for
K1, each slot's sum) is rounded to bf16 on both sides, but XLA's CPU
arithmetic can put an f32 value on the other side of a bf16 rounding
boundary, which moves that term by one bf16 step (2^-8 relative): held
to 2^-7 of the largest |value|, and most entries are held tighter.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ingp_tpu.ops import brickgrid as jb
from ingp_tpu.ops import composite as jcomp
from ingp_tpu.ops import streambrick as js
from ingp_tpu.ops.pallas.brickreduce_pallas import fused_brick_reduce
from ingp_tpu.ops.pallas.composite_pallas import composite_pallas
from ingp_tpu.ops.pallas.rayreduce_pallas import fused_ray_reduce as j_frr

from ingp_tpu_torch.kernels import brickreduce as k2
from ingp_tpu_torch.kernels import build
from ingp_tpu_torch.kernels import composite as k3
from ingp_tpu_torch.kernels import rayreduce as k1
from ingp_tpu_torch.ops import brickgrid as tb
from ingp_tpu_torch.ops import composite as tcomp
from ingp_tpu_torch.ops import streambrick as ts
from tests._torch_threads import one_torch_thread  # noqa: F401

BF16_STEP = 2.0 ** -7


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return np.asarray(a, dtype=np.float32)


def close_f32(out, ref, atol_frac=1e-6):
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=atol_frac * np.abs(ref).max())


# Whole-encoder gradients go through XLA's CPU dot form of the reduce
# (reduce_feats_jac) on the JAX side, which strays up to 6.7e-6 of the
# largest |value| from a float64 evaluation where the port's plain
# backward stays within 6.5e-8 (measured on the brickgrid case below).
ENC_ATOL_FRAC = 1e-5


def close_bf16(out, ref):
    err = np.abs(out - ref)
    scale = np.abs(ref).max()
    assert err.max() <= BF16_STEP * scale, (err.max(), scale)
    # a step is rare: nearly every entry agrees to f32 rounding
    assert (err <= 1e-5 * scale).mean() > 0.99


def _scatter_rows(rows, dG, n_rows):
    """The f32 master gradient of a gather of `rows` with cotangent dG."""
    W = dG.shape[-1]
    return N(jnp.zeros((n_rows, W), jnp.float32).at[rows.reshape(-1)].add(
        jnp.asarray(dG).reshape(-1, W).astype(jnp.float32)))


def _round_bf16(a):
    return N(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------- K1 bwd

def _k1_case(seed, B, U, K, F, n_rows=200, bf16=False, jac=True):
    rng = np.random.default_rng(seed)
    W = 32 * F
    table = rng.normal(size=(n_rows, W)).astype(np.float32)
    if bf16:
        table = _round_bf16(table)
    urows = rng.integers(0, n_rows, (B, U)).astype(np.int32)
    # the grouped plan's clipped running run counts
    uid = np.minimum(np.cumsum(rng.random((B, K)) < 0.25, 1),
                     U - 1).astype(np.int32)
    loc = rng.integers(0, 2, (3, B, K)).astype(np.float32)
    loc[:, :, ::9] = -9.0
    frac = rng.uniform(0, 1, (3, B, K)).astype(np.float32)
    sc = np.full((1, B, K), 37.5, np.float32)
    lf = np.concatenate([loc, frac, sc, np.zeros((1, B, K), np.float32)])
    df = rng.normal(size=(F, B, K)).astype(np.float32)
    dj = rng.normal(size=(3 * F, B, K)).astype(np.float32) if jac else None
    return table, urows, uid, lf, df, dj


def _k1_jax_grad(table, urows, uid, lf, df, dj, F, with_jac, jac_lo,
                 jac_hi, bf16):
    g_u = jnp.asarray(table[urows], jnp.bfloat16 if bf16 else jnp.float32)
    _, vjp = jax.vjp(lambda g: j_frr(g, uid, lf, F, with_jac, jac_lo,
                                     jac_hi, True), g_u)
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    cts = (jnp.asarray(df), jnp.asarray(dj[:3 * Fj]) if with_jac else None)
    (dG,) = vjp(cts)
    return _scatter_rows(urows, dG, table.shape[0])


def _k1_port_grad(table, urows, uid, lf, df, dj, F, jac_lo, jac_hi, bf16):
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    grad = torch.zeros(table.shape)
    k1.fused_ray_reduce_bwd(grad, T(urows), T(uid), T(lf), T(df),
                            None if dj is None else T(dj[:3 * Fj]), F,
                            jac_lo, jac_hi, bf16)
    return N(grad)


@pytest.mark.parametrize("F,B,U,K,window,with_jac,bf16", [
    (8, 8, 48, 256, (0, None), True, False),    # one k-slab
    (8, 8, 48, 256, (0, None), True, True),     # bf16, one k-slab
    (4, 8, 32, 256, (1, 3), True, False),       # partial jac window
    (8, 8, 32, 256, (0, None), False, False),   # no jacobian
    (8, 8, 640, 512, (0, None), True, False),   # two k-slabs, U chunks
])
def test_k1_bwd_plain_matches_pallas_vjp(F, B, U, K, window, with_jac,
                                         bf16):
    jac_lo, jac_hi = window
    table, urows, uid, lf, df, dj = _k1_case(1, B, U, K, F, bf16=bf16,
                                             jac=with_jac)
    ref = _k1_jax_grad(table, urows, uid, lf, df, dj, F, with_jac, jac_lo,
                       jac_hi, bf16)
    out = _k1_port_grad(table, urows, uid, lf, df, dj, F, jac_lo, jac_hi,
                        bf16)
    (close_bf16 if bf16 else close_f32)(out, ref)
    assert np.abs(ref).max() > 0


def test_k1_bwd_marked_cells_add_exact_zeros():
    F, B, U, K = 8, 8, 32, 256
    table, urows, uid, lf, df, dj = _k1_case(2, B, U, K, F)
    marked = lf[0] == -9.0
    df = np.where(marked[None], df, 0.0).astype(np.float32)
    dj = np.where(marked[None], dj, 0.0).astype(np.float32)
    uid[:, 3::11] = U + 5                         # outside [0, U)
    df[:, :, 3::11] = 1.0
    for bf16 in (False, True):
        out = _k1_port_grad(table, urows, uid, lf, df, dj, F, 0, None, bf16)
        assert not out.any()


def test_k1_bwd_matches_ad_of_xla_reduce():
    """The same gradient from JAX AD of the XLA form: rows expanded by
    slot id and reduced by reduce_feats_jac."""
    F, B, U, K = 4, 2, 24, 96
    table, urows, uid, lf, df, dj = _k1_case(3, B, U, K, F, n_rows=60)
    cfg = jb.BrickGridConfig(n_levels=1, n_features=F, log2_bricks=8)
    lf[6] = cfg.scales[0]
    n = B * K
    local = lf[0:3].reshape(3, 1, n)
    frac = lf[3:6].reshape(3, 1, n)
    rows = np.take_along_axis(urows, uid, 1).reshape(-1)
    cts = (jnp.asarray(df.reshape(F, n).T),
           jnp.asarray(dj.reshape(3, F, n).transpose(0, 2, 1)))
    _, vjp = jax.vjp(lambda t: jb.reduce_feats_jac(cfg, t[rows], local,
                                                   frac, n), table)
    ref = N(vjp(cts)[0])
    out = _k1_port_grad(table, urows, uid, lf, df, dj, F, 0, None, False)
    close_f32(out, ref)


# ---------------------------------------------------------------- K2 bwd

def _k2_case(seed, Lw, n, F, n_rows, bf16=False, jac=True):
    rng = np.random.default_rng(seed)
    W = 32 * F
    table = rng.normal(size=(n_rows, W)).astype(np.float32)
    if bf16:
        table = _round_bf16(table)
    rows = rng.integers(0, n_rows, (Lw, n)).astype(np.int32)
    loc = rng.integers(0, 2, (3, Lw, n)).astype(np.float32)
    loc[:, :, ::7] = -9.0
    frac = rng.uniform(0, 1, (3, Lw, n)).astype(np.float32)
    sc = np.broadcast_to(rng.uniform(5, 50, (1, Lw, 1)), (1, Lw, n))
    lf = np.concatenate([loc, frac, sc, np.zeros((1, Lw, n))], 0
                        ).astype(np.float32)
    df = rng.normal(size=(n, Lw * F)).astype(np.float32)
    dj = rng.normal(size=(3, n, Lw * F)).astype(np.float32) if jac else None
    return table, rows, lf, df, dj


def _k2_port_grad(table, rows, lf, df, dj, F, jac_lo=0, jac_hi=None,
                  bf16=False):
    grad = torch.zeros(table.shape)
    k2.brick_reduce_bwd(grad, T(rows), T(lf), T(df),
                        None if dj is None else T(dj), F, jac_lo, jac_hi,
                        bf16)
    return N(grad)


@pytest.mark.parametrize("bf16", [False, True])
def test_k2_bwd_plain_matches_pallas_vjp(bf16):
    F, Lw, n = 8, 2, 512
    table, rows, lf, df, dj = _k2_case(4, Lw, n, F, 300, bf16)
    g = jnp.asarray(table, jnp.bfloat16 if bf16 else jnp.float32
                    )[rows.reshape(-1)]
    _, vjp = jax.vjp(lambda g: fused_brick_reduce(g, lf.reshape(8, -1), F,
                                                  True), g)
    # port layout (N, Lw*F) / (3, N, Lw*F) -> feature-major (F, Lw*n)
    dfj = df.reshape(n, Lw, F).transpose(2, 1, 0).reshape(F, -1)
    djj = dj.reshape(3, n, Lw, F).transpose(0, 3, 2, 1).reshape(3 * F, -1)
    (dg,) = vjp((jnp.asarray(dfj), jnp.asarray(djj)))
    ref = _scatter_rows(rows, dg, table.shape[0])
    out = _k2_port_grad(table, rows, lf, df, dj, F, bf16=bf16)
    (close_bf16 if bf16 else close_f32)(out, ref)


@pytest.mark.parametrize("window,with_jac,bf16", [
    ((0, None), True, False), ((1, 3), True, False),
    ((0, None), False, False), ((0, None), True, True)])
def test_k2_bwd_plain_matches_ad_of_reduce_feats_jac(window, with_jac,
                                                     bf16):
    F, Lw, n = 4, 3, 200
    jac_lo, jac_hi = window
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    table, rows, lf, df, dj = _k2_case(5, Lw, n, F, 97, bf16, with_jac)
    cfg = jb.BrickGridConfig(n_levels=Lw, n_features=F, log2_bricks=8)
    lf[6] = np.asarray(cfg.scales, np.float32)[:, None]
    if with_jac:
        dj = dj.reshape(3, n, Lw, F)[..., jac_lo:jac_lo + Fj].reshape(
            3, n, -1)
    # the JAX direct path gathers a bf16 block and reduces it in f32: AD
    # rounds the per-row cotangent to bf16 at the convert
    st = jnp.asarray(table, jnp.bfloat16 if bf16 else jnp.float32)
    g_st = st[rows.reshape(-1)]

    def fwd_g(g):
        g = g.astype(jnp.float32)
        if with_jac:
            return jb.reduce_feats_jac(cfg, g, lf[0:3], lf[3:6], n, jac_lo,
                                       jac_hi)
        return jb.reduce_feats(cfg, g, lf[0:3], lf[3:6], n)

    _, vjp = jax.vjp(fwd_g, g_st)
    (dg,) = vjp((jnp.asarray(df), jnp.asarray(dj)) if with_jac
                else jnp.asarray(df))
    ref = _scatter_rows(rows, dg, table.shape[0])
    out = _k2_port_grad(table, rows, lf, df, dj if with_jac else None, F,
                        jac_lo, jac_hi, bf16)
    (close_bf16 if bf16 else close_f32)(out, ref)


def test_k2_bwd_marked_cells_add_exact_zeros():
    F, Lw, n = 8, 2, 300
    table, rows, lf, df, dj = _k2_case(6, Lw, n, F, 50)
    marked = (lf[0] == -9.0).T                      # (n, Lw)
    df = (df.reshape(n, Lw, F) * marked[..., None]).reshape(n, -1)
    dj = (dj.reshape(3, n, Lw, F) * marked[None, ..., None]).reshape(
        3, n, -1)
    rows[:, 1::13] = 10 ** 6                        # outside the table
    df[1::13] = 1.0
    for bf16 in (False, True):
        assert not _k2_port_grad(table, rows, lf, df, dj, F,
                                 bf16=bf16).any()


def test_k2_bwd_chunking_is_invisible(monkeypatch):
    F, Lw, n = 4, 3, 300
    table, rows, lf, df, dj = _k2_case(7, Lw, n, F, 50)
    ref = _k2_port_grad(table, rows, lf, df, dj, F)
    monkeypatch.setattr(k2, "PLAIN_CHUNK", 16)
    # other chunks add a row's cells in another order
    close_f32(_k2_port_grad(table, rows, lf, df, dj, F), ref)


# ---------------------------------------------------------------- K3 bwd

def _composite_case(seed, R, S, C=0):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, S + 1, R)
    valid = np.arange(S)[None] < n[:, None]
    sig = rng.uniform(0, 40, (R, S)).astype(np.float32)
    dt = np.full((R, S), np.sqrt(3) / 1024 * 8, np.float32)
    ts_ = (np.cumsum(dt, 1) + 0.3).astype(np.float32)
    rgbs = rng.uniform(0, 1, (3, R, S)).astype(np.float32)
    aux = rng.normal(size=(C, R, S)).astype(np.float32)
    return sig, dt, ts_, valid, rgbs, aux


@pytest.mark.parametrize("thr", [1e-4, 1e-2])
def test_k3_bwd_plain_matches_pallas_vjp(thr):
    R, S = 16, 128
    sig, dt, ts_, valid, rgbs, _ = _composite_case(8, R, S)
    rng = np.random.default_rng(9)
    dws = rng.normal(size=(R, S)).astype(np.float32)
    dO, dD = rng.normal(size=(2, R)).astype(np.float32)
    dC = rng.normal(size=(R, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda s, c: composite_pallas(s, c, dt, ts_, valid,
                                                   thr, True), sig, rgbs)
    dsj, drj = vjp((dws, dO, dD, dC))
    dst, drt, dat = k3.composite_bwd(
        T(sig), T(dt), T(ts_), T(valid), thr, T(rgbs),
        torch.zeros((0, R, S)), T(dws), T(dO), T(dD), T(dC),
        torch.zeros((R, 0)))
    close_f32(N(dst), N(dsj))
    close_f32(N(drt), N(drj))
    assert dat.shape == (0, R, S)
    # dsigma is exactly zero where a sample is not included
    Tb = np.exp(-(np.cumsum(sig * dt * valid, 1) - sig * dt * valid))
    assert not N(dst)[~(valid & (Tb > thr))].any()


def test_k3_autograd_matches_ad_of_composite_rays():
    """composite_rays with the aux composites (normals, semantics) and
    every output's cotangent, against JAX AD of the XLA composite."""
    R, S, thr = 24, 40, 1e-2
    sig, dt, ts_, valid, rgbs, aux = _composite_case(10, R, S, C=13)
    rng = np.random.default_rng(11)
    keys = ("ws", "opacity", "depth", "rgb", "normal_pred", "normal_raw",
            "semantic")
    shapes = {"ws": (R, S), "opacity": (R,), "depth": (R,), "rgb": (R, 3),
              "normal_pred": (R, 3), "normal_raw": (R, 3),
              "semantic": (R, 7)}
    cts = {k: rng.normal(size=shapes[k]).astype(np.float32) for k in keys}

    def jloss(s, c, a):
        out = jcomp.composite_rays(s, c, dt, ts_, valid, thr,
                                   normals_pred=a[:3], normals_raw=a[3:6],
                                   sems=a[6:])
        return sum(jnp.sum(out[k] * cts[k]) for k in keys)

    gj = jax.grad(jloss, argnums=(0, 1, 2))(sig, rgbs, aux)
    st, ct, at = (T(a).requires_grad_() for a in (sig, rgbs, aux))
    out = tcomp.composite_rays(st, ct, T(dt), T(ts_), T(valid), thr,
                               normals_pred=at[:3], normals_raw=at[3:6],
                               sems=at[6:])
    sum((out[k] * T(cts[k])).sum() for k in keys).backward()
    for a, b in zip((st.grad, ct.grad, at.grad), gj):
        close_f32(N(a), N(b))


def test_k3_launch_counts_and_no_grad_path():
    R, S = 8, 16
    sig, dt, ts_, valid, rgbs, _ = _composite_case(12, R, S)
    n0 = dict(build.LAUNCHES)
    st = T(sig).requires_grad_()
    out = k3.composite(st, T(dt), T(ts_), T(valid), 1e-2, rgbs=T(rgbs))
    out["opacity"].sum().backward()
    # CPU tensors run the plain versions: nothing is launched
    assert dict(build.LAUNCHES) == n0
    with torch.no_grad():
        plain = k3.composite(st, T(dt), T(ts_), T(valid), 1e-2,
                             rgbs=T(rgbs))
    np.testing.assert_array_equal(N(plain["ws"]), N(out["ws"].detach()))


# ------------------------------------------------ encoders end to end

ARGS = dict(n_levels=8, n_features=4, log2_bricks=10, base_resolution=16,
            per_level_scale=1.45)
JCFG, TCFG = jb.BrickGridConfig(**ARGS), tb.BrickGridConfig(**ARGS)


def _ray_stream(seed, n_rays=96, max_seg=24):
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, max_seg, n_rays)
    o = rng.uniform(0, 1, (n_rays, 3)) * 0.5 + 0.25
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    xs = [np.clip(o[r] + np.arange(lens[r])[:, None] * (np.sqrt(3) / 1024)
                  * d[r], 0, 1) for r in range(n_rays)]
    return np.concatenate(xs).astype(np.float32).T


@pytest.mark.parametrize("storage,chunk", [(None, 512),
                                           ("bfloat16", 65536)])
def test_stream_encode_grad_matches_grouped_jax(monkeypatch, storage,
                                                chunk):
    """d/d table of a loss on features and jacobian: the port's K1/K2
    backward into one f32 accumulator against JAX AD through the grouped
    path (its Pallas kernels interpreted). chunk 512 runs the stream in
    several chunks."""
    table = N(jb.brickgrid_init(jax.random.PRNGKey(7), JCFG)) * 1e3
    x = _ray_stream(8)
    rng = np.random.default_rng(13)
    n = x.shape[1]
    cf = rng.normal(size=(n, 32)).astype(np.float32)
    cj = rng.normal(size=(3, n, 32)).astype(np.float32)
    monkeypatch.setenv("INGP_STREAM_GROUPED", "1")
    monkeypatch.setenv("INGP_STREAM_GROUPED_INTERPRET", "1")
    js.streambrick_encode_grad.clear_cache()
    sd = None if storage is None else jnp.bfloat16

    def jloss(t):
        f, j = js.streambrick_encode_grad(JCFG, t, x, tile=256, chunk=chunk,
                                          storage_dtype=sd)
        return jnp.sum(f * cf) + jnp.sum(j * cj)

    try:
        gj = N(jax.grad(jloss)(table))
    finally:
        js.streambrick_encode_grad.clear_cache()
    tt = T(table).requires_grad_()
    f, j = ts.streambrick_encode_grad(TCFG, tt, T(x), tile=256, chunk=chunk,
                                      storage_dtype=storage)
    ((f * T(cf)).sum() + (j * T(cj)).sum()).backward()
    assert tt.grad.dtype == torch.float32
    if storage:
        close_bf16(N(tt.grad), gj)
    else:
        close_f32(N(tt.grad), gj, ENC_ATOL_FRAC)


def test_brickgrid_encode_grad_matches_jax():
    table = N(jb.brickgrid_init(jax.random.PRNGKey(3), JCFG)) * 1e3
    x = np.random.default_rng(14).uniform(0, 1, (3, 700)).astype(np.float32)
    cf = np.random.default_rng(15).normal(size=(700, 32)).astype(np.float32)
    gj = N(jax.grad(lambda t: jnp.sum(jb.brickgrid_encode(
        JCFG, t, x, chunk=256, x_cm=True) * cf))(table))
    tt = T(table).requires_grad_()
    (tb.brickgrid_encode(TCFG, tt, T(x), chunk=256, x_cm=True)
     * T(cf)).sum().backward()
    close_f32(N(tt.grad), gj, ENC_ATOL_FRAC)
    # and the port against float64 arithmetic of the same function
    rows, local, frac = tb.brick_coords(TCFG, T(x))
    g64 = torch.zeros(table.shape, dtype=torch.float64)
    k2.brick_reduce_bwd_plain(g64, rows, tb.level_lf(TCFG, local, frac
                                                     ).double(),
                              T(cf).double(), None, 4)
    close_f32(N(tt.grad), g64.numpy(), 1e-7)


# ------------------------------------------------------ compaction VJPs

@pytest.mark.parametrize("cm", [False, True])
def test_pack_vjps_match_jax(cm):
    """gather_samples / scatter_back (and their channel-major forms)
    against the JAX custom_vjps, on a batch that overflows its budget."""
    from ingp_tpu.ops import pack as jp
    from ingp_tpu_torch.ops import pack as tp
    rng = np.random.default_rng(16)
    R, S, K, C = 30, 12, 200, 3
    valid = rng.random((R, S)) < 0.7
    jplan = jp.compact_samples(valid, K)
    tplan = tp.compact_samples(T(valid), K)
    shape = (C, R, S) if cm else (R, S, C)
    arr = rng.normal(size=shape).astype(np.float32)
    vals = rng.normal(size=(C, K) if cm else (K, C)).astype(np.float32)
    jg, js_ = (jp.gather_samples_cm, jp.scatter_back_cm) if cm else \
        (jp.gather_samples, jp.scatter_back)
    tg, ts_ = (tp.gather_samples_cm, tp.scatter_back_cm) if cm else \
        (tp.gather_samples, tp.scatter_back)
    for jf, tf, x, ct_shape in ((jg, tg, arr, vals.shape),
                                (js_, ts_, vals, arr.shape)):
        ct = rng.normal(size=ct_shape).astype(np.float32)
        out_j, vjp = jax.vjp(lambda a: jf(a, jplan), x)
        xt = T(x).requires_grad_()
        out_t = tf(xt, tplan)
        (out_t * T(ct)).sum().backward()
        np.testing.assert_array_equal(N(out_t.detach()), N(out_j))
        np.testing.assert_array_equal(N(xt.grad), N(vjp(ct)[0]))
