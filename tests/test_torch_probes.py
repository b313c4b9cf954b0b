"""The probes' plain versions (ingp_tpu_torch/probes) against JAX on the
same arrays, at small sizes.

- The gathers against the references the TPU probes check their own
  output with: `t.at[i].get` / `jnp.take` (rows), `jnp.take_along_axis`
  on axes 0 and 1, and the flat `jnp.take` -- exactly.
- The K1 split's `full` forward and backward against
  ingp_tpu.ops.pallas.rayreduce_pallas `fused_ray_reduce` run in
  interpret mode and its custom_vjp, at integer local coordinates (the
  TPU kernel's weight planes match a lattice point by equality, so a
  fractional coordinate weighs nothing there, while the CUDA kernels
  truncate it).
- The split's stubs against numpy formulas written from the TPU probe's
  kernel body (benchmarking/probe_kernel_split.py:101-160, with the
  importable `_selT_blockdiag` and `_point_coords`). Where the Hopper
  stub computes something else (no-planes keeps the 8 corners, the TPU
  stub all 27 points; no-dot keeps one corner, the TPU stub a lane
  slice), the test says so, holds the port's stub to a formula of its
  own and checks where the two meet.
- The split's backward stubs against a numpy walk of the CUDA kernel's
  loop (runs, flushes, stores), in f32 and with the bf16 rounding the
  probe runs (each cell's lane cotangent and each run's sum), and the
  bf16 `full` against the custom_vjp on a bf16 block.
- The K2 split's `full` against ingp_tpu.ops.pallas.brickreduce_pallas
  `fused_brick_reduce` in interpret mode (integer local coordinates, as
  above), its stubs against `full` and a numpy formula.

The probes' Pallas kernels themselves are closures inside each probe's
`main()` and cannot be imported without editing the probes, which stay
as they are; so the references are the JAX functions and formulas
above.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ingp_tpu.ops.pallas.brickreduce_pallas import _point_coords
from ingp_tpu.ops.pallas.brickreduce_pallas import fused_brick_reduce as j_fbr
from ingp_tpu.ops.pallas.rayreduce_pallas import _selT_blockdiag
from ingp_tpu.ops.pallas.rayreduce_pallas import fused_ray_reduce as j_frr

from ingp_tpu_torch.kernels import build, rayreduce
from ingp_tpu_torch.probes import common
from ingp_tpu_torch.probes import gather_layouts as pg
from ingp_tpu_torch.probes import kernel_split as ps
from ingp_tpu_torch.probes import row_layouts as pr
from ingp_tpu_torch.probes import vmem_gather as pv
from tests._torch_threads import one_torch_thread  # noqa: F401

F, W = 8, 256


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return np.asarray(a, dtype=np.float32)


def _bf16(a):
    return N(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# ------------------------------------------------------------- gathers

@pytest.mark.parametrize("inner,dtype", [((256,), "bf16"), ((16, 128), "bf16"),
                                         ((8, 128), "f32")])
def test_row_gather_plain_matches_jax(inner, dtype):
    rng = np.random.default_rng(0)
    n_rows, n = 300, 1024
    t = rng.standard_normal((n_rows,) + inner).astype(np.float32)
    jt = jnp.asarray(t, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    i = rng.integers(0, n_rows, n).astype(np.int32)
    ref = jt.at[i].get(mode="promise_in_bounds")
    tt = T(N(jt.astype(jnp.float32)))
    tt = tt.to(torch.bfloat16) if dtype == "bf16" else tt
    out = pr.row_gather(tt, T(i))
    assert out.dtype == tt.dtype
    np.testing.assert_array_equal(N(out.float()), N(ref.astype(jnp.float32)))


def test_gather_rows_plain_matches_jax():
    rng = np.random.default_rng(1)
    for rows in (8192, pv.SMEM_ROWS):
        t = rng.standard_normal((rows, W)).astype(np.float32)
        i = rng.integers(0, rows, 4096).astype(np.int32)
        ref = N(jnp.take(jnp.asarray(t), jnp.asarray(i), axis=0))
        for where in ("l2", "smem"):
            np.testing.assert_array_equal(
                N(pv.gather_rows(T(t), T(i), where)), ref)


@pytest.mark.parametrize("form", ["axis0", "axis0 large", "axis1", "flat"])
def test_in_block_gathers_match_jax(form):
    """The TPU probe's own tables and references (:127-131, :163-165,
    :185-187)."""
    rng = np.random.default_rng(2)
    table = np.arange(512 * 128, dtype=np.int32).reshape(512, 128)
    if form.startswith("axis0"):
        idx = rng.integers(0, 512, (8192 if "large" in form else 256, 128)
                           ).astype(np.int32)
        ref = jnp.take_along_axis(jnp.asarray(table), jnp.asarray(idx), 0)
        out = pg.take_axis0(T(table), T(idx))
    elif form == "axis1":
        table = table[:256]
        idx = rng.integers(0, 128, (256, 128)).astype(np.int32)
        ref = jnp.take_along_axis(jnp.asarray(table), jnp.asarray(idx), 1)
        out = pg.take_axis1(T(table), T(idx))
    else:
        idx = rng.integers(0, 512 * 128, (256, 128)).astype(np.int32)
        ref = jnp.take(jnp.asarray(table).reshape(-1), jnp.asarray(idx))
        out = pg.take_flat(T(table), T(idx), "cluster")
        np.testing.assert_array_equal(
            pg.take_flat(T(table), T(idx), "global").numpy(), np.asarray(ref))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_gathers_give_zeros_outside_the_table():
    """An id outside the table reads nothing (the kernels' contract; JAX
    clamps or fills instead, so the port is held to zeros)."""
    table = torch.arange(1, 512 * 128 + 1, dtype=torch.int32).reshape(512,
                                                                      128)
    idx = torch.full((4, 128), 0, dtype=torch.int32)
    idx[1] = -1
    idx[2] = 512 * 128
    idx[3] = 512
    assert not pg.take_axis0(table, idx)[1:].any()
    assert not pg.take_axis1(table[:4], torch.where(
        idx == 0, 0, torch.where(idx == 512, 128, idx)))[1:].any()
    assert not pg.take_flat(table, idx)[1:3].any()
    rows = torch.randn(10, 256)
    i = torch.tensor([0, -1, 10, 3], dtype=torch.int32)
    for out in (pr.row_gather(rows.to(torch.bfloat16), i),
                pv.gather_rows(rows, i)):
        assert not out[1:3].any() and out[0].any() and out[3].any()


def test_wrappers_reject_other_devices_and_count_no_launch():
    n0 = sum(build.LAUNCHES.values())
    meta = torch.empty((8, 256), device="meta")
    i = torch.zeros(4, dtype=torch.int32, device="meta")
    for fn in (lambda: pr.row_gather(meta, i),
               lambda: pv.gather_rows(meta, i),
               lambda: pg.take_flat(meta.int(), i.reshape(2, 2)),
               lambda: pg.take_axis0(meta.int(), i.reshape(2, 2)),
               lambda: pg.take_axis1(meta.int(), i.reshape(2, 2)),
               lambda: ps.split_fwd("full", meta, i.reshape(2, 2),
                                    i.reshape(2, 2), meta)):
        with pytest.raises(ValueError, match="unsupported device"):
            fn()
    assert sum(build.LAUNCHES.values()) == n0


# --------------------------------------------------- K1 split, forward

def _split_case(seed, B=8, U=12, K=256, n_rows=300, order="random",
                integer=True):
    """Split inputs: a bf16-valued table, urows, uid (uniform or sorted
    along the row), lf with integer local coordinates (or uniform in
    [0, 1) as the TPU probe draws them), f32 cotangents."""
    rng = np.random.default_rng(seed)
    table = _bf16(rng.standard_normal((n_rows, W)))
    urows = rng.integers(0, n_rows, (B, U)).astype(np.int32)
    uid = rng.integers(0, U, (B, K)).astype(np.int32)
    if order == "sorted":
        uid = np.sort(uid, 1)
    lf = rng.uniform(0, 1, (8, B, K)).astype(np.float32)
    if integer:
        lf[0:3] = rng.integers(0, 2, (3, B, K))
    lf[6] = 21.5
    df = rng.standard_normal((F, B, K)).astype(np.float32)
    dj = rng.standard_normal((3 * F, B, K)).astype(np.float32)
    return table, urows, uid, lf, df, dj


def _port_fwd(mode, table, urows, uid, lf):
    f, j = ps.split_fwd(mode, T(table).to(torch.bfloat16), T(urows), T(uid),
                        T(lf))
    return N(f), N(j)


def _close(out, ref, rtol=1e-5):
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("order", ["random", "sorted"])
def test_split_full_fwd_matches_pallas_interpret(order):
    table, urows, uid, lf, _, _ = _split_case(3, order=order)
    ref = j_frr(jnp.asarray(table[urows], jnp.bfloat16), jnp.asarray(uid),
                jnp.asarray(lf), F, True, 0, None, True)
    for mode in ("full", "rowpair-2", "rowpair-4"):
        out = _port_fwd(mode, table, urows, uid, lf)
        for a, b in zip(out, ref):
            _close(a, N(b))


def _tpu_stub(mode, g_u, uid, lf):
    """The TPU probe's kernel body (make_kernel, :101-160) in numpy for
    one mode: one-hot expand, lane-domain weight planes, the select dot
    (or its stubs). Returns (feats (F, R, K), jac (3F, R, K))."""
    sel = N(_selT_blockdiag(W, F, 0, F, True))            # (4F, 4W)
    pi, pj, pk = (np.asarray(c)[0] for c in _point_coords())
    p = np.arange(W) // F
    lane = [c[p] for c in (pi, pj, pk)]                   # (W,) each
    R, K = uid.shape
    feats = np.zeros((F, R, K), np.float32)
    jac = np.zeros((3 * F, R, K), np.float32)
    for r in range(R):
        g = g_u[r][np.zeros(K, int) if mode == "no-expand" else uid[r]]
        if mode == "no-planes":
            w = d1 = d2 = d3 = np.ones((K, W), np.float32)
        else:
            ax = []
            for a in range(3):
                loc, fr = lf[a, r][:, None], lf[3 + a, r][:, None]
                at0, at1 = lane[a][None] == loc, lane[a][None] == loc + 1
                ax.append((np.where(at0, 1 - fr, np.where(at1, fr, 0.0)),
                           np.where(at0, -1.0, np.where(at1, 1.0, 0.0))))
            (wx, dwx), (wy, dwy), (wz, dwz) = ax
            w, d1 = wx * (wy * wz), dwx * (wy * wz)
            d2, d3 = dwy * (wx * wz), dwz * (wx * wy)
        planes = (w, d1, d2, d3)
        if mode == "bf16-planes":
            planes = [_bf16(g) * _bf16(x) for x in planes]
            big = _bf16(np.concatenate(planes, 1))
        else:
            big = np.concatenate([g * x for x in planes], 1)
        if mode == "no-dot":
            feats[:, r] = big[:, :F].T
            jac[:, r] = big[:, :3 * F].T
        else:
            out = sel @ big.T
            feats[:, r] = out[:F]
            jac[:, r] = out[F:] * lf[6, r][None]
    return feats, jac


def _port_stub(mode, g_u, uid, lf):
    """The Hopper stub of `mode` in numpy: the 8 corners of the cell with
    weight 1 and the derivative's sign (no-planes), only the cell's own
    corner with its trilinear weights (no-dot), or the 8 corners with
    weights and products rounded to bf16 and summed in f32 in corner
    order (bf16-planes)."""
    R, K = uid.shape
    feats = np.zeros((F, R, K), np.float32)
    jac = np.zeros((3, F, R, K), np.float32)
    corners = [(0, 0, 0)] if mode == "no-dot" else \
        [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    for r in range(R):
        g = g_u[r][uid[r]].reshape(K, W // F, F)
        loc = lf[0:3, r].astype(int)
        fx, fy, fz = lf[3:6, r]
        for a, b, c in corners:
            v = g[np.arange(K), 9 * (loc[0] + a) + 3 * (loc[1] + b)
                  + loc[2] + c].T                          # (F, K)
            if mode == "no-planes":
                w, dw = 1.0, [1.0 if s else -1.0 for s in (a, b, c)]
            else:
                wx, wy, wz = [x if s else 1 - x
                              for x, s in zip((fx, fy, fz), (a, b, c))]
                sg = [1.0 if s else -1.0 for s in (a, b, c)]
                w = wx * wy * wz
                dw = [sg[0] * wy * wz, wx * sg[1] * wz, wx * wy * sg[2]]
            if mode == "bf16-planes":
                feats[:, r] += _bf16(_bf16(w) * v)
                for ax in range(3):
                    jac[ax, :, r] += _bf16(_bf16(dw[ax]) * v)
                continue
            feats[:, r] += w * v
            for ax in range(3):
                jac[ax, :, r] += dw[ax] * v
    return feats, (jac * lf[6][None, None]).reshape(3 * F, R, K)


@pytest.mark.parametrize("mode", ["no-planes", "no-expand", "no-dot",
                                  "bf16-planes"])
def test_split_fwd_stubs(mode):
    table, urows, uid, lf, _, _ = _split_case(4, B=4, K=64)
    g_u = table[urows]
    out = _port_fwd(mode, table, urows, uid, lf)
    if mode == "no-expand":
        # the same stub on both machines: every cell reads slot 0's row
        for a, b in zip(out, _tpu_stub(mode, g_u, uid, lf)):
            _close(a, b)
        return
    for a, b in zip(out, _port_stub(mode, g_u, uid, lf)):
        _close(a, b)
    tpu = _tpu_stub(mode, g_u, uid, lf)
    if mode == "bf16-planes":
        # the same bf16 products on both machines, summed in another
        # order (the TPU's select dot over 27 points, of which the 19
        # off the cell's corners weigh 0); the weights' f32 products are
        # rounded to bf16 after another order too, so a rare one lands
        # a bf16 step (2^-8) apart
        for a, b in zip(out, tpu):
            err, scale = np.abs(a - b), np.abs(b).max()
            assert err.max() <= 2 ** -7 * scale
            assert (err <= 1e-5 * scale).mean() > 0.99
    elif mode == "no-dot":
        # TPU: the first F lanes of g*w (lattice point 0) and the first
        # 3F lanes, unscaled, as the jacobian; Hopper: the cell's own
        # corner. At local cell (0, 0, 0) that corner is point 0, so the
        # features agree there
        at0 = (lf[0:3] == 0).all(0)
        _close(out[0][:, at0], tpu[0][:, at0])
    else:
        # TPU: weight 1 on all 27 points; Hopper: on the cell's 8
        # corners. With the other points zeroed the features agree
        R, K = uid.shape
        g_cells = g_u[np.arange(R)[:, None], uid].reshape(R, K, W // F, F)
        loc = lf[0:3].astype(int)
        keep = np.zeros((R, K, W // F), bool)
        for a in (0, 1):
            for b in (0, 1):
                for c in (0, 1):
                    pt = 9 * (loc[0] + a) + 3 * (loc[1] + b) + loc[2] + c
                    np.put_along_axis(keep, pt[..., None], True, 2)
        g_zeroed = np.where(keep[..., None], g_cells, 0.0)
        _close(out[0], g_zeroed[:, :, :27].sum(2).transpose(2, 0, 1))


def test_split_fwd_probe_draw():
    """lf uniform in [0, 1) in every plane, as the TPU probe draws it:
    local coordinates truncate to cell (0, 0, 0), which the kernels'
    `ingp_local_ok` accepts, so no cell reads as zero."""
    table, urows, uid, lf, _, _ = _split_case(5, B=4, K=64, integer=False)
    lf0 = lf.copy()
    lf0[0:3] = 0.0
    for mode in ("full", "no-planes", "no-dot"):
        out = _port_fwd(mode, table, urows, uid, lf)
        ref = _port_fwd(mode, table, urows, uid, lf0)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        assert (np.abs(out[0]).sum(0) > 0).all()


# -------------------------------------------------- K1 split, backward

def _jax_bwd(table, urows, uid, lf, df, dj, bf16=False):
    g_u = jnp.asarray(table[urows], jnp.bfloat16 if bf16 else jnp.float32)
    _, vjp = jax.vjp(lambda g: j_frr(g, uid, lf, F, True, 0, None, True),
                     g_u)
    (dG,) = vjp((jnp.asarray(df), jnp.asarray(dj)))
    return N(jnp.zeros(table.shape, jnp.float32).at[urows.reshape(-1)].add(
        dG.reshape(-1, W).astype(jnp.float32)))


def _port_bwd(mode, table, urows, uid, lf, df, dj, bf16=False):
    grad = torch.zeros(table.shape)
    scratch = torch.zeros((urows.size, W)) if mode == "no-atomics" else None
    return N(ps.split_bwd(mode, grad, T(urows), T(uid), T(lf), T(df), T(dj),
                          scratch, bf16=bf16))


@pytest.mark.parametrize("order", ["random", "sorted"])
def test_split_full_bwd_matches_pallas_vjp(order):
    table, urows, uid, lf, df, dj = _split_case(6, order=order)
    ref = _jax_bwd(table, urows, uid, lf, df, dj)
    _close(_port_bwd("full", table, urows, uid, lf, df, dj), ref)


def test_split_full_bwd_bf16_matches_pallas_vjp():
    """bf16 (the probe's setting: the shipping kernel's rounding for a
    bf16 table) against the custom_vjp on a bf16 block, with a sorted
    uid: one run per slot, so rounding each run's sum is rounding each
    slot's sum, as the TPU kernel does. XLA's CPU arithmetic can put an
    f32 value on the other side of a bf16 rounding boundary, which moves
    that term by one bf16 step: held as tests/test_torch_grad.py holds
    K1's bf16 backward (2^-7 of the largest value, 99% of the entries
    within 1e-5 of it). The shipping kernel's own plain version agrees
    with the split's to f32 rounding."""
    table, urows, uid, lf, df, dj = _split_case(6, order="sorted")
    ref = _jax_bwd(table, urows, uid, lf, df, dj, bf16=True)
    out = _port_bwd("full", table, urows, uid, lf, df, dj, bf16=True)
    err, scale = np.abs(out - ref), np.abs(ref).max()
    assert err.max() <= 2 ** -7 * scale
    assert (err <= 1e-5 * scale).mean() > 0.99
    ship = N(rayreduce.fused_ray_reduce_bwd_plain(
        torch.zeros(table.shape), T(urows), T(uid), T(lf), T(df), T(dj), F,
        bf16=True))
    _close(out, ship)
    np.testing.assert_array_equal(
        _port_bwd("shipping", table, urows, uid, lf, df, dj, bf16=True),
        out)


def _walk_kernel(mode, n_rows, urows, uid, lf, df, dj, bf16=False):
    """The CUDA backward's loop in numpy: per batch row, every lane walks
    the cells, sums each run of a slot in order and flushes it (an add
    into the master, or a store into the slot's scratch row); with bf16
    each cell's lane cotangent and each flushed sum rounded to bf16."""
    B, U = urows.shape
    K = 1 if mode == "walk-1" else uid.shape[1]
    grad = np.zeros((n_rows, W), np.float32)
    scratch = np.zeros((B * U, W), np.float32)
    q = np.arange(W)
    p, f = q // F, q % F
    pi, pj, pk = p // 9, (p // 3) % 3, p % 3
    lane_ok = q < 27 * F
    for b in range(B):
        acc = np.zeros(W, np.float32)
        cur = -1

        def flush():
            if cur < 0:
                return
            live = lane_ok & (acc != 0)
            val = _bf16(acc) if bf16 else acc
            if mode == "no-atomics":
                scratch[b * U + cur, live] = val[live]
            else:
                grad[urows[b, cur], live] += val[live]

        for k in range(K):
            u = uid[b, k]
            lx, ly, lz = lf[0:3, b, k]
            if not (0 <= u < U and all(0 <= x <= 1 for x in (lx, ly, lz))):
                continue
            if u != cur:
                flush()
                cur, acc = u, np.zeros(W, np.float32)
            a, bb, e = pi - int(lx), pj - int(ly), pk - int(lz)
            corner = lane_ok & (a >= 0) & (a <= 1) & (bb >= 0) & (bb <= 1) \
                & (e >= 0) & (e <= 1)
            if mode == "no-planes":
                w = np.float32(1)
                d = [np.where(x == 1, 1, -1).astype(np.float32)
                     for x in (a, bb, e)]
            else:
                fr = lf[3:6, b, k]
                wv = [np.where(x == 1, fr[i], np.float32(1) - fr[i])
                      for i, x in enumerate((a, bb, e))]
                dv = [np.where(x == 1, 1, -1).astype(np.float32)
                      for x in (a, bb, e)]
                pyz = wv[1] * wv[2]
                w = wv[0] * pyz
                d = [dv[0] * pyz, dv[1] * (wv[0] * wv[2]),
                     dv[2] * (wv[0] * wv[1])]
            t = (dj[f, b, k] * d[0] + dj[F + f, b, k] * d[1]) \
                + dj[2 * F + f, b, k] * d[2]
            v = df[f, b, k] * w + t * lf[6, b, k]
            if bf16:
                v = _bf16(v)
            acc = acc + np.where(corner, v, 0).astype(np.float32)
        flush()
    return scratch if mode == "no-atomics" else grad


def _walk_case(order):
    table, urows, uid, lf, df, dj = _split_case(7, B=4, U=6, K=48,
                                                n_rows=40, order=order,
                                                integer=False)
    uid[1, ::5] = 9                                 # outside [0, U)
    lf[0:3, 2, ::7] = -9.0                          # the overflow marker
    return table, urows, uid, lf, df, dj


@pytest.mark.parametrize("mode", ["full", "no-atomics", "no-planes",
                                  "walk-1", "staged", "shipping"])
@pytest.mark.parametrize("order", ["random", "sorted"])
def test_split_bwd_matches_kernel_walk(mode, order):
    table, urows, uid, lf, df, dj = _walk_case(order)
    ref = _walk_kernel(mode, table.shape[0], urows, uid, lf, df, dj)
    _close(_port_bwd(mode, table, urows, uid, lf, df, dj), ref)
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("mode", list(ps.BWD_MODES))
@pytest.mark.parametrize("order", ["random", "sorted"])
def test_split_bwd_bf16_matches_kernel_walk(mode, order):
    """The probe's bf16 rounding: each cell's lane cotangent and each
    run's sum (per run, not per slot, where a random uid breaks a slot
    into runs)."""
    table, urows, uid, lf, df, dj = _walk_case(order)
    ref = _walk_kernel(mode, table.shape[0], urows, uid, lf, df, dj, True)
    out = _port_bwd(mode, table, urows, uid, lf, df, dj, bf16=True)
    _close(out, ref)
    assert np.abs(ref).max() > 0
    assert not np.array_equal(
        out, _port_bwd(mode, table, urows, uid, lf, df, dj))


# ----------------------------------------------------- K2 split, forward

def _k2_case(seed, Lw=2, n=512, n_rows=300):
    """K2 split inputs: a bf16-valued table, rows over it, lf with
    integer local cells (the Pallas K2 matches lattice points by
    equality), -9 on every 7th cell and a per-level scale."""
    rng = np.random.default_rng(seed)
    table = _bf16(rng.standard_normal((n_rows, W)))
    rows = rng.integers(0, n_rows, (Lw, n)).astype(np.int32)
    loc = rng.integers(0, 2, (3, Lw, n)).astype(np.float32)
    loc[:, :, ::7] = -9.0
    frac = rng.uniform(0, 1, (3, Lw, n)).astype(np.float32)
    sc = np.broadcast_to(np.float32(16.0) * (1 + np.arange(Lw))[:, None],
                         (1, Lw, n))
    lf = np.concatenate([loc, frac, sc, np.zeros((1, Lw, n))]
                        ).astype(np.float32)
    return table, rows, lf


def _port_k2(mode, table, rows, lf, with_jac=True):
    f, j = ps.split_k2(mode, T(table).to(torch.bfloat16), T(rows), T(lf),
                       with_jac)
    return N(f), None if j is None else N(j)


@pytest.mark.parametrize("mode", ["full", "shipping"])
def test_split_k2_full_matches_pallas_interpret(mode):
    """The replaced K2 body (and the shipping kernel's plain version) against
    the TPU kernel on the same gathered rows, in the port's (N, Lw*F)
    layout."""
    Lw, n = 2, 512
    table, rows, lf = _k2_case(11, Lw, n)
    g = jnp.asarray(table, jnp.bfloat16)[rows.reshape(-1)]
    fj, jj = j_fbr(g, jnp.asarray(lf.reshape(8, -1)), F, True)
    fj = N(fj).reshape(F, Lw, n).transpose(2, 1, 0).reshape(n, Lw * F)
    jj = N(jj).reshape(3, F, Lw, n).transpose(0, 3, 2, 1).reshape(3, n, -1)
    f, j = _port_k2(mode, table, rows, lf)
    _close(f, fj)
    _close(j, jj)
    assert (f[::7] == 0).all() and (np.abs(f).sum(1) > 0).sum() > n // 2


@pytest.mark.parametrize("with_jac", [True, False])
def test_split_k2_stubs(with_jac):
    """no-jac-stores: full's features, no jacobian; coalesced-feats:
    full's features feature-major (cell n*Lw + l); no-corners: every
    valid cell reduces the corners of cell (0, 0, 0) of row 0."""
    Lw, n = 3, 100
    table, rows, lf = _k2_case(12, Lw, n)
    full = _port_k2("full", table, rows, lf, with_jac)
    assert (full[1] is None) == (not with_jac)
    if with_jac:
        f, j = _port_k2("no-jac-stores", table, rows, lf)
        np.testing.assert_array_equal(f, full[0])
        assert j is None
    f, j = _port_k2("coalesced-feats", table, rows, lf, with_jac)
    np.testing.assert_array_equal(
        f, full[0].reshape(n * Lw, F).T)
    if with_jac:
        np.testing.assert_array_equal(j, full[1])
    f, j = _port_k2("no-corners", table, rows, lf, with_jac)
    ok = (lf[0:3] >= 0).all(0)                       # (Lw, n)
    lf0 = lf.copy()
    lf0[0:3] = np.where(ok, 0.0, lf[0:3])
    ref = _port_k2("full", table, np.zeros_like(rows), lf0, with_jac)
    np.testing.assert_array_equal(f, ref[0])
    assert (f.reshape(n, Lw, F)[ok.T] != 0).any()
    if with_jac:
        np.testing.assert_array_equal(j, ref[1])
        # the 8 corners of cell (0, 0, 0) of row 0, weighted (a numpy
        # formula of the trilerp)
        g = table[0, :27 * F].reshape(27, F)
        fr = lf[3:6].transpose(2, 1, 0)              # (n, Lw, 3)
        feats = np.zeros((n, Lw, F))
        for a in (0, 1):
            for b in (0, 1):
                for c in (0, 1):
                    w = np.prod([fr[..., i] if s_ else 1 - fr[..., i]
                                 for i, s_ in enumerate((a, b, c))], 0)
                    feats += w[..., None] * g[9 * a + 3 * b + c]
        feats = np.where(ok.T[..., None], feats, 0.0).reshape(n, Lw * F)
        np.testing.assert_allclose(f, feats, rtol=1e-5, atol=1e-5)


def test_split_k2_rejects_no_jac_stores_without_jac():
    table, rows, lf = _k2_case(13, 1, 16)
    with pytest.raises(ValueError):
        _port_k2("no-jac-stores", table, rows, lf, False)


def test_split_bwd_full_without_jacobian_cotangent():
    """The backward `full` with djac None (the rgb table's form) equals
    its walk with a zero jacobian cotangent; the stubs refuse it."""
    table, urows, uid, lf, df, dj = _walk_case("sorted")
    out = ps.split_bwd("full", torch.zeros(table.shape[0], W), T(urows),
                       T(uid), T(lf), T(df), None, bf16=True)
    ref = _walk_kernel("full", table.shape[0], urows, uid, lf, df,
                       np.zeros_like(dj), True)
    np.testing.assert_array_equal(N(out), ref)
    with pytest.raises(ValueError):
        ps.split_bwd("no-planes", torch.zeros(table.shape[0], W), T(urows),
                     T(uid), T(lf), T(df), None)


def test_probe_cases_run_on_the_cpu(capsys):
    """The CPU route of the probes' entry points: plain versions only,
    one line per variant, no kernel launched."""
    n0 = sum(build.LAUNCHES.values())
    cpu = torch.device("cpu")
    cases = (ps.cases(cpu, groups=((8, 12),), n_rows=64,
                      k2_groups=(("Lw 4, jac", 4, 40, True),
                                 ("Lw 16, no jac", 16, 9, False)),
                      k2_rows=64,
                      k2b_groups=(("Lw 4, jac", 4, 70, True, 64),
                                  ("Lw 4, no jac", 4, 33, False, 80)),
                      k3b_shape=(20, 24, 3))
             + pr.cases(cpu, shapes=(((256,), torch.bfloat16, 512, 100),))
             + pv.cases(cpu, rows=64, n=512) + pg.cases(cpu, big_rows=64))
    for c in cases:
        out, ref = c.plain(), c.kernel()
        for a, b in zip(common._flat(out), common._flat(ref)):
            assert torch.equal(a, b)
    assert common.run(cases, cpu, 1) == []
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(cases) == 24 + 9 + 10 + 2 + 2 + 1 + 3 + 8
    assert all("plain version on the CPU" in s for s in lines)
    assert sum(build.LAUNCHES.values()) == n0
