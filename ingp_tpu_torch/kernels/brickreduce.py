"""K2: per-sample brick trilerp reduce with the table gather fused in.

Replaces the forward of ingp_tpu/ops/pallas/brickreduce_pallas.py
`fused_brick_reduce` (and, on the JAX main path, the XLA
`brickgrid.reduce_feats` / `reduce_feats_jac` after a table gather).
The CUDA kernel (`csrc/brickreduce.cu`) takes the storage table and the
row ids, so the gathered (n, W) row block never exists; it is bound by
the bytes of the corner points it reads (see the source's note).

`trilerp_rows_plain` is the shared plain arithmetic of K1 and K2.
"""
from __future__ import annotations

import torch

from . import build

SUPPORTED_F = (2, 4, 8)
PLAIN_CHUNK = 1 << 16     # cells per step of the plain versions

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
    brick_reduce.launches += 1
    return feats, jac


brick_reduce.launches = 0
