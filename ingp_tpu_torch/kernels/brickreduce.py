"""K2: per-sample brick trilerp reduce with the table gather fused in.

Replaces the forward of ingp_tpu/ops/pallas/brickreduce_pallas.py
`fused_brick_reduce` (and, on the JAX main path, the XLA
`brickgrid.reduce_feats` / `reduce_feats_jac` after a table gather).
The CUDA kernel (`csrc/brickreduce.cu`) takes the storage table and the
row ids, so the gathered (n, W) row block never exists; it is bound by
the bytes of the corner points it reads (see the source's note).

`trilerp_rows_plain` is the shared plain arithmetic of K1 and K2, and
`trilerp_rows_bwd_plain` that of their backward kernels.

The backward (`brick_reduce_bwd`, `csrc/brickreduce.cu`) replaces
`_fbr_bwd` of brickreduce_pallas.py: it computes each cell's per-lane
cotangent of its row and scatter-adds it straight into the f32 master
gradient of the table (the forward fused the gather, so there is no
gathered block to hand a cotangent to). It takes the feature and
jacobian cotangents at any row stride, so the column slices that
`torch.cat`'s backward hands over need no copy. `BrickReduceFn` binds
forward and backward into a `torch.autograd.Function`.

The backward's position-cotangent variant (`brick_reduce_bwd_and_pos`,
`ingp_brick_reduce_bwd_and_pos` in `csrc/brickreduce.cu`) also gives, in
the same launch, each cell's cotangent of its fractional position frac
(lf rows 3-5), which JAX's XLA form of the reduce
(`brickgrid.reduce_feats` / `reduce_feats_jac`) carries through AD and
its Pallas form drops (`_fbr_bwd` returns a zero lf cotangent).
`BrickReduceFn` launches it in place of `brick_reduce_bwd` only when lf
requires a gradient: with pose refinement, whose sample positions depend
on the refined poses.
"""
from __future__ import annotations

import torch

from . import build

SUPPORTED_F = (2, 4, 8, 16)
PLAIN_CHUNK = 1 << 16     # cells per step of the plain versions
BWD_MAX_LEVELS = 256      # brickreduce.cu: a tile's cells fill one block

_CORNERS = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]


def trilerp_rows_plain(g, lf, F: int, with_jac: bool, jac_lo: int = 0,
                       Fj: int | None = None):
    """Trilinear reduce of brick rows g (n, W) (27 points x F features,
    lane p*F + f, p = 9i + 3j + k) at lf (8, n) = [lx, ly, lz, fx, fy,
    fz, scale, 0]. A cell whose local coordinate is outside [0, 1] on any
    axis (the -9 overflow marker) gets exact zeros.

    Returns (feats (n, F), jac (3, n, Fj) = scale * d feats / d frac over
    the feature window [jac_lo, jac_lo + Fj), or None)."""
    Fj = F - jac_lo if Fj is None else Fj
    n = g.shape[0]
    loc, fr, sc = lf[0:3], lf[3:6], lf[6]
    ok = ((loc >= 0) & (loc <= 1)).all(0)
    li = loc.clamp(0, 1).to(torch.int64)
    pts = g[:, :27 * F].float().reshape(n, 27, F)
    ar = torch.arange(n, device=g.device)
    feats = torch.zeros((n, F), device=g.device)
    jac = torch.zeros((3, n, Fj), device=g.device) if with_jac else None
    for a, b, c in _CORNERS:
        v = pts[ar, 9 * (li[0] + a) + 3 * (li[1] + b) + (li[2] + c)]
        wx = fr[0] if a else 1.0 - fr[0]
        wy = fr[1] if b else 1.0 - fr[1]
        wz = fr[2] if c else 1.0 - fr[2]
        feats += (wx * wy * wz)[:, None] * v
        if with_jac:
            vj = v[:, jac_lo:jac_lo + Fj]
            jac[0] += ((1.0 if a else -1.0) * wy * wz)[:, None] * vj
            jac[1] += (wx * (1.0 if b else -1.0) * wz)[:, None] * vj
            jac[2] += (wx * wy * (1.0 if c else -1.0))[:, None] * vj
    zero = torch.zeros((), device=g.device)
    feats = torch.where(ok[:, None], feats, zero)
    if with_jac:
        jac = torch.where(ok[None, :, None], jac * sc[None, :, None], zero)
    return feats, jac


def _lane_points(F: int, W: int, device):
    """Lattice coordinates (i, j, k) of each lane's point (-1 on the
    padding lanes past 27*F) and each lane's feature."""
    q = torch.arange(W, device=device)
    p = q // F
    pad = p >= 27
    return (torch.where(pad, -1, p // 9), torch.where(pad, -1, (p // 3) % 3),
            torch.where(pad, -1, p % 3), q % F)


def _axis_w(lane, loc, fr):
    """Per-lane weight along one axis, (1 - f) at the cell's own lattice
    index and f at the next, and its derivative d w / d frac."""
    at0 = lane[None].float() == loc[:, None]
    at1 = lane[None].float() == loc[:, None] + 1.0
    fr = fr[:, None]
    w = torch.where(at0, 1.0 - fr, torch.where(at1, fr, 0.0))
    d = torch.where(at0, -1.0, torch.where(at1, 1.0, 0.0))
    return w, d


def trilerp_rows_bwd_plain(lf, df, dj, F: int, W: int, jac_lo: int = 0,
                           Fj: int | None = None):
    """Per-lane cotangent (n, W) of brick rows read at lf (8, n), from the
    feature cotangent df (n, F) and the jacobian cotangent dj (3, n, Fj)
    or None:

      dg[q] = df[f] * w_q + ((dj_x[f] d1_q + dj_y[f] d2_q) + dj_z[f] d3_q)
              * scale

    for lane q = p*F + f, with w = wx*(wy*wz), d1 = dwx*(wy*wz),
    d2 = dwy*(wx*wz), d3 = dwz*(wx*wy) (the weight planes of
    brickreduce_pallas.py `_plane_weights`, in the same order, so that a
    kernel that rounds after every operation gives the same bits).
    Cells outside [0, 1] (the -9 marker) and padding lanes get exact
    zeros."""
    Fj = F - jac_lo if Fj is None else Fj
    li, lj, lk, lane_f = _lane_points(F, W, lf.device)
    wx, dwx = _axis_w(li, lf[0], lf[3])
    wy, dwy = _axis_w(lj, lf[1], lf[4])
    wz, dwz = _axis_w(lk, lf[2], lf[5])
    pyz = wy * wz
    dg = df[:, lane_f] * (wx * pyz)
    if dj is not None:
        o = (lane_f - jac_lo).clamp(0, Fj - 1)
        t = (dj[0][:, o] * (dwx * pyz) + dj[1][:, o] * (dwy * (wx * wz))
             ) + dj[2][:, o] * (dwz * (wx * wy))
        in_win = (lane_f >= jac_lo) & (lane_f < jac_lo + Fj)
        dg = torch.where(in_win[None], dg + t * lf[6][:, None], dg)
    ok = ((lf[0:3] >= 0) & (lf[0:3] <= 1)).all(0)
    return torch.where(ok[:, None] & (li >= 0)[None], dg, 0.0)


def trilerp_rows_pos_bwd_plain(g, lf, df, dj, F: int, jac_lo: int = 0,
                               Fj: int | None = None):
    """Cotangent (3, n) of the fractional positions lf[3:6] of cells
    reading brick rows g (n, W) at lf (8, n), from the feature cotangent
    df (n, F) and the jacobian cotangent dj (3, n, Fj) or None:

      dfrac_a = sum_corner d_a w_b w_c <v, df>
                + scale * (d_a d_b w_c <v_j, dj_b> + d_a d_c w_b <v_j, dj_c>)

    for each of the 8 corner points v (F features; v_j its jacobian
    window), {a, b, c} the three axes, w the corner's weight along an
    axis and d = dw / dfrac = -1 or +1 (the trilinear weight has no
    second derivative along one axis). Cells outside [0, 1] (the -9
    marker) get exact zeros."""
    Fj = F - jac_lo if Fj is None else Fj
    n = g.shape[0]
    loc, fr, sc = lf[0:3], lf[3:6], lf[6]
    ok = ((loc >= 0) & (loc <= 1)).all(0)
    li = loc.clamp(0, 1).to(torch.int64)
    pts = g[:, :27 * F].float().reshape(n, 27, F)
    ar = torch.arange(n, device=g.device)
    out = torch.zeros((3, n), device=g.device)
    for corner in _CORNERS:
        v = pts[ar, 9 * (li[0] + corner[0]) + 3 * (li[1] + corner[1])
                + (li[2] + corner[2])]
        w = [fr[k] if corner[k] else 1.0 - fr[k] for k in range(3)]
        d = [1.0 if corner[k] else -1.0 for k in range(3)]
        s_df = (v * df).sum(1)
        if dj is not None:
            vj = v[:, jac_lo:jac_lo + Fj]
            s_j = [(vj * dj[k]).sum(1) for k in range(3)]
        for a in range(3):
            b, c = (a + 1) % 3, (a + 2) % 3
            term = d[a] * w[b] * w[c] * s_df
            if dj is not None:
                term = term + sc * d[a] * (d[b] * w[c] * s_j[b]
                                           + d[c] * w[b] * s_j[c])
            out[a] += term
    return torch.where(ok[None], out, 0.0)


def round_bf16(x):
    """x rounded to bfloat16 (nearest even), carried as float32."""
    return x.to(torch.bfloat16).float()


def _jac_window(F, jac_lo, jac_hi):
    jac_hi = F if jac_hi is None else jac_hi
    if not 0 <= jac_lo < jac_hi <= F:
        raise ValueError(f"bad jacobian window [{jac_lo}, {jac_hi}) "
                         f"for F={F}")
    return jac_hi - jac_lo


def brick_reduce_plain(table, rows, lf, F: int, with_jac: bool = True,
                       jac_lo: int = 0, jac_hi: int | None = None):
    """Plain PyTorch version of `brick_reduce` (same contract). Gathers
    PLAIN_CHUNK cells at a time, so that its (cells, W) row blocks stay
    small at any N."""
    Fj = _jac_window(F, jac_lo, jac_hi)
    Lw, N = rows.shape
    feats = torch.empty((N, Lw * F), device=table.device)
    jac = torch.empty((3, N, Lw * Fj), device=table.device) \
        if with_jac else None
    step = max(1, PLAIN_CHUNK // max(Lw, 1))
    for n0 in range(0, N, step):
        sl = slice(n0, min(n0 + step, N))
        c = sl.stop - n0
        r = rows[:, sl].reshape(-1).to(torch.int64)
        in_table = (r >= 0) & (r < table.shape[0])
        g = table[r.clamp(0, table.shape[0] - 1)]
        lfc = lf[:, :, sl].reshape(8, -1)
        lfc = torch.cat([torch.where(in_table, lfc[:3], -9.0), lfc[3:]])
        f, j = trilerp_rows_plain(g, lfc, F, with_jac, jac_lo, Fj)
        feats[sl] = f.reshape(Lw, c, F).permute(1, 0, 2).reshape(c, Lw * F)
        if with_jac:
            jac[:, sl] = j.reshape(3, Lw, c, Fj).permute(0, 2, 1, 3
                                                         ).reshape(3, c, -1)
    return feats, jac


def brick_reduce(table, rows, lf, F: int, with_jac: bool = True,
                 jac_lo: int = 0, jac_hi: int | None = None):
    """Trilerp-reduce brick rows gathered from `table` for every
    (level, sample) cell.

    Args:
      table: (n_rows, W) f32 or bf16 storage table, W >= 27*F.
      rows: (Lw, N) int32 table row per (level, sample).
      lf: (8, Lw, N) f32 [lx, ly, lz, fx, fy, fz, scale, 0].
      F: features per lattice point; jac_lo/jac_hi: jacobian window.

    Returns (feats (N, Lw*F), jac (3, N, Lw*Fj) or None) in the layout
    of ingp_tpu's reduce_feats_jac (level-major feature axis)."""
    if table.device.type == "cpu":
        return brick_reduce_plain(table, rows, lf, F, with_jac, jac_lo,
                                  jac_hi)
    if table.device.type != "cuda":
        raise ValueError(f"brick_reduce: unsupported device {table.device}")
    Fj = _jac_window(F, jac_lo, jac_hi)
    dev = table.device
    build.check_cuda_tensor("table", table, (torch.float32, torch.bfloat16),
                            2, dev, align=16)
    build.check_cuda_tensor("rows", rows, (torch.int32,), 2, dev)
    build.check_cuda_tensor("lf", lf, (torch.float32,), 3, dev)
    Lw, N = rows.shape
    W = table.shape[1]
    if F not in SUPPORTED_F or W < 27 * F or W % 8:
        raise ValueError(f"brick_reduce: unsupported F={F}, W={W}")
    if lf.shape != (8, Lw, N):
        raise ValueError(f"lf shape {tuple(lf.shape)} != (8, {Lw}, {N})")
    feats = torch.empty((N, Lw * F), device=dev)
    jac = torch.empty((3, N, Lw * Fj), device=dev) if with_jac else None
    if Lw * N == 0:
        return feats, jac
    with torch.cuda.device(dev):
        build.launch("ingp_brick_reduce_fwd", build.ptr(table),
                     int(table.dtype == torch.bfloat16), table.shape[0],
                     build.ptr(rows), build.ptr(lf), build.ptr(feats),
                     build.ptr(jac), Lw, N, W, F, int(with_jac), jac_lo, Fj,
                     build.stream_of(dev))
    return feats, jac


def brick_reduce_bwd_plain(grad, rows, lf, dfeats, djac, F: int,
                           jac_lo: int = 0, jac_hi: int | None = None,
                           bf16: bool = False):
    """Plain PyTorch version of `brick_reduce_bwd` (same contract),
    PLAIN_CHUNK cells at a time; the cells' rows are added into `grad`
    in level-major order."""
    Fj = _jac_window(F, jac_lo, jac_hi)
    Lw, N = rows.shape
    n_rows, W = grad.shape
    step = max(1, PLAIN_CHUNK // max(Lw, 1))
    for n0 in range(0, N, step):
        sl = slice(n0, min(n0 + step, N))
        c = sl.stop - n0
        r = rows[:, sl].reshape(-1).to(torch.int64)
        in_table = (r >= 0) & (r < n_rows)
        lfc = lf[:, :, sl].reshape(8, -1)
        lfc = torch.cat([torch.where(in_table, lfc[:3], -9.0), lfc[3:]])
        dfc = dfeats[sl].reshape(c, Lw, F).transpose(0, 1).reshape(-1, F)
        djc = None if djac is None else \
            djac[:, sl].reshape(3, c, Lw, Fj).transpose(1, 2).reshape(
                3, -1, Fj)
        dg = trilerp_rows_bwd_plain(lfc, dfc, djc, F, W, jac_lo, Fj)
        if bf16:
            dg = round_bf16(dg)
        grad.index_add_(0, r.clamp(0, n_rows - 1), dg)
    return grad


def brick_reduce_bwd(grad, rows, lf, dfeats, djac, F: int, jac_lo: int = 0,
                     jac_hi: int | None = None, bf16: bool = False):
    """Backward of `brick_reduce`: add every cell's row cotangent into
    the f32 master gradient `grad` (n_rows, W), in place.

    Args:
      grad: (n_rows, W) f32, accumulated into (16-byte aligned, W a
        multiple of 4 on the card).
      rows, lf, F, jac_lo, jac_hi: as given to `brick_reduce` (Lw at most
        BWD_MAX_LEVELS on the card).
      dfeats: (N, Lw*F) f32 cotangent of feats; djac: (3, N, Lw*Fj) f32
        cotangent of jac, or None (no jacobian in the forward). Their
        last axis is contiguous; the other strides are free.
      bf16: round each cell's per-lane cotangent to bfloat16 before the
        f32 add, as the JAX path does when it reads the table through a
        bf16 storage copy (its gathered block's cotangent is bf16).

    Cells marked -9 (or whose row lies outside the table) add exactly
    nothing. Returns grad."""
    if grad.device.type == "cpu":
        return brick_reduce_bwd_plain(grad, rows, lf, dfeats, djac, F,
                                      jac_lo, jac_hi, bf16)
    if grad.device.type != "cuda":
        raise ValueError(f"brick_reduce_bwd: unsupported device "
                         f"{grad.device}")
    Fj, vec, dj_strides = _bwd_checks("brick_reduce_bwd", grad, rows, lf,
                                      dfeats, djac, F, jac_lo, jac_hi, 4)
    Lw, N = rows.shape
    if Lw * N == 0:
        return grad
    with torch.cuda.device(grad.device):
        build.launch("ingp_brick_reduce_bwd", build.ptr(grad),
                     grad.shape[0], build.ptr(rows), build.ptr(lf),
                     build.ptr(dfeats), dfeats.stride(0), build.ptr(djac),
                     *dj_strides, Lw, N, grad.shape[1], F,
                     int(djac is not None), jac_lo, Fj, int(bf16), vec,
                     build.stream_of(grad.device))
    return grad


def _bwd_checks(name, grad, rows, lf, dfeats, djac, F, jac_lo, jac_hi,
                w_mult):
    """The K2 backward's checks of its arguments on the card (W a
    multiple of w_mult); returns (Fj, vec, the jacobian cotangent's plane
    and row strides)."""
    Fj = _jac_window(F, jac_lo, jac_hi)
    dev = grad.device
    # 16-byte rows: the kernel adds each lattice point's F lanes with
    # vector atomics
    build.check_cuda_tensor("grad", grad, (torch.float32,), 2, dev, align=16)
    build.check_cuda_tensor("rows", rows, (torch.int32,), 2, dev)
    build.check_cuda_tensor("lf", lf, (torch.float32,), 3, dev)
    Lw, N = rows.shape
    W = grad.shape[1]
    if F not in SUPPORTED_F or W < 27 * F or W % w_mult:
        raise ValueError(f"{name}: unsupported F={F}, W={W}")
    if Lw > BWD_MAX_LEVELS:
        raise ValueError(f"{name}: Lw = {Lw} > {BWD_MAX_LEVELS}")
    if lf.shape != (8, Lw, N):
        raise ValueError(f"shape mismatch: lf {tuple(lf.shape)}, rows "
                         f"{(Lw, N)}")
    vec = _check_rows("dfeats", dfeats, (N, Lw * F), dev)
    dj_strides = (0, 0)
    if djac is not None:
        vec |= _check_rows("djac", djac, (3, N, Lw * Fj), dev) << 1
        dj_strides = djac.stride()[:2]
    return Fj, vec, dj_strides


def brick_reduce_bwd_and_pos(grad, storage, rows, lf, dfeats, djac, F: int,
                             jac_lo: int = 0, jac_hi: int | None = None,
                             bf16: bool = False):
    """`brick_reduce_bwd` into `grad` and, in the same pass over the
    cells, the cotangent of `brick_reduce`'s fractional positions (lf
    rows 3-5): each cell reads its cotangents once for both. Returns dpos
    (3, Lw, N) f32, as `brick_reduce_bwd_pos_plain` gives it.

    Args: those of `brick_reduce_bwd`, and `storage`, the (n_rows, W)
    table the forward read (f32, or bf16 exactly when bf16; W a multiple
    of 8 on the card), whose 8 corner points of its row each cell reads.
    Cells marked -9, whose row lies outside the table or whose cotangents
    are all zero get exact zeros."""
    if grad.device.type == "cpu":
        brick_reduce_bwd_plain(grad, rows, lf, dfeats, djac, F, jac_lo,
                               jac_hi, bf16)
        return brick_reduce_bwd_pos_plain(storage, rows, lf, dfeats, djac,
                                          F, jac_lo, jac_hi)
    if grad.device.type != "cuda":
        raise ValueError(f"brick_reduce_bwd_and_pos: unsupported device "
                         f"{grad.device}")
    Fj, vec, dj_strides = _bwd_checks("brick_reduce_bwd_and_pos", grad, rows,
                                      lf, dfeats, djac, F, jac_lo, jac_hi, 8)
    dtype = torch.bfloat16 if bf16 else torch.float32
    build.check_cuda_tensor("storage", storage, (dtype,), 2, grad.device,
                            align=16)
    if storage.shape != grad.shape:
        raise ValueError(f"storage shape {tuple(storage.shape)} != grad "
                         f"{tuple(grad.shape)}")
    Lw, N = rows.shape
    dpos = torch.empty((3, Lw, N), device=grad.device)
    if Lw * N == 0:
        return dpos
    with torch.cuda.device(grad.device):
        build.launch("ingp_brick_reduce_bwd_and_pos", build.ptr(grad),
                     build.ptr(storage), grad.shape[0], build.ptr(rows),
                     build.ptr(lf), build.ptr(dfeats), dfeats.stride(0),
                     build.ptr(djac), *dj_strides, build.ptr(dpos), Lw, N,
                     grad.shape[1], F, int(djac is not None), jac_lo, Fj,
                     int(bf16), vec, build.stream_of(grad.device))
    return dpos


def brick_reduce_bwd_pos_plain(table, rows, lf, dfeats, djac, F: int,
                               jac_lo: int = 0, jac_hi: int | None = None):
    """The cotangent of `brick_reduce`'s fractional positions, in plain
    PyTorch: (3, Lw, N) f32, each cell's d loss / d lf[3:6] from the
    feature cotangent dfeats (N, Lw*F) and the jacobian cotangent djac
    (3, N, Lw*Fj) or None, reading the 8 corner points of its row of
    `table` (f32 or bf16 storage) as the forward did; PLAIN_CHUNK cells
    at a time. Cells marked -9, or whose row lies outside the table, get
    exact zeros. `brick_reduce_bwd_and_pos` returns it beside the table
    gradient."""
    Fj = _jac_window(F, jac_lo, jac_hi)
    Lw, N = rows.shape
    out = torch.empty((3, Lw, N), device=table.device)
    step = max(1, PLAIN_CHUNK // max(Lw, 1))
    for n0 in range(0, N, step):
        sl = slice(n0, min(n0 + step, N))
        c = sl.stop - n0
        r = rows[:, sl].reshape(-1).to(torch.int64)
        in_table = (r >= 0) & (r < table.shape[0])
        g = table[r.clamp(0, table.shape[0] - 1)]
        lfc = lf[:, :, sl].reshape(8, -1)
        lfc = torch.cat([torch.where(in_table, lfc[:3], -9.0), lfc[3:]])
        dfc = dfeats[sl].reshape(c, Lw, F).transpose(0, 1).reshape(-1, F)
        djc = None if djac is None else \
            djac[:, sl].reshape(3, c, Lw, Fj).transpose(1, 2).reshape(
                3, -1, Fj)
        out[:, :, sl] = trilerp_rows_pos_bwd_plain(
            g, lfc, dfc, djc, F, jac_lo, Fj).reshape(3, Lw, c)
    return out


def _check_rows(name, t, shape, dev) -> int:
    """A cotangent handed to `brick_reduce_bwd`: f32 on dev of `shape`,
    each row (the last axis) contiguous, at any outer strides. Returns 1
    when its rows may be read with 16-byte loads (16-byte aligned start,
    strides and row length multiples of 4 floats), else 0."""
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"float32 on {dev}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{name}: rows must be contiguous")
    if t.data_ptr() % 4:
        raise ValueError(f"{name}: data pointer not 4-byte aligned")
    return int(t.data_ptr() % 16 == 0 and shape[-1] % 4 == 0
               and all(s % 4 == 0 for s in t.stride()[:-1]))


def rows_unit_stride(t):
    """t, or a contiguous copy where its last axis is not contiguous."""
    return t if t.stride(-1) == 1 or t.shape[-1] <= 1 else t.contiguous()


class BrickReduceFn(torch.autograd.Function):
    """`brick_reduce` on a table read (ops/gather.py `TableRead`),
    differentiable w.r.t. the f32 master table behind it and, where lf
    requires a gradient, w.r.t. lf's fractional positions.

    Inputs: the read's token (the autograd link to the master), its
    gradient sink, the storage table that the forward kernel reads, and
    the `brick_reduce` arguments. The backward runs `brick_reduce_bwd`
    into the sink's f32 accumulator or, when lf needs a gradient,
    `brick_reduce_bwd_and_pos`, which also gives lf rows 3-5 their
    cotangent (the other rows, the local cell and the scale, get zeros);
    rows get none."""

    @staticmethod
    def forward(ctx, token, sink, storage, rows, lf, F, with_jac, jac_lo,
                jac_hi):
        feats, jac = brick_reduce(storage, rows, lf, F, with_jac, jac_lo,
                                  jac_hi)
        ctx.save_for_backward(rows, lf)
        ctx.cfg = (sink, F, jac_lo, jac_hi,
                   storage.dtype == torch.bfloat16)
        # the table is read again only by the position cotangent
        ctx.storage = storage if ctx.needs_input_grad[4] else None
        if jac is None:
            return feats, feats.new_empty(0)
        return feats, jac

    @staticmethod
    def backward(ctx, dfeats, djac):
        rows, lf = ctx.saved_tensors
        sink, F, jac_lo, jac_hi, bf16 = ctx.cfg
        dj = rows_unit_stride(djac) if djac.numel() else None
        df = rows_unit_stride(dfeats)
        dlf = None
        if ctx.storage is None:
            brick_reduce_bwd(sink.buffer(), rows, lf, df, dj, F, jac_lo,
                             jac_hi, bf16)
        else:
            dpos = brick_reduce_bwd_and_pos(sink.buffer(), ctx.storage, rows,
                                            lf, df, dj, F, jac_lo, jac_hi,
                                            bf16)
            zero = dpos.new_zeros((1,) + tuple(dpos.shape[1:]))
            dlf = torch.cat([zero.expand(3, -1, -1), dpos,
                             zero.expand(2, -1, -1)])
        return (sink.token_grad(), None, None, None, dlf) + (None,) * 4


def brick_reduce_read(read, rows, lf, F: int, with_jac: bool = True,
                      jac_lo: int = 0, jac_hi: int | None = None):
    """`brick_reduce` on a table read (ops/gather.py `table_read`):
    through `BrickReduceFn` when the read carries a gradient token, else
    straight on its storage."""
    if read.token is None:
        return brick_reduce(read.storage, rows, lf, F, with_jac, jac_lo,
                            jac_hi)
    feats, jac = BrickReduceFn.apply(read.token, read.sink, read.storage,
                                     rows, lf, F, with_jac, jac_lo, jac_hi)
    return feats, (jac if with_jac else None)
