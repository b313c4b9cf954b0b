"""K1: fused unique-row expand + trilerp reduce of the stream encoder.

Replaces the forward of ingp_tpu/ops/pallas/rayreduce_pallas.py
`fused_ray_reduce`. The TPU kernel expands unique rows, gathered
beforehand into a (B, U, W) block, with a one-hot MXU matmul (Mosaic has
no vector gather); the CUDA kernel (`csrc/rayreduce.cu`) takes the
storage table and the unique rows' table ids and reads each cell's row
by index, so the block never exists. It is bound by bytes moved (see
the source's note).
"""
from __future__ import annotations

import torch

from . import build
from .brickreduce import (PLAIN_CHUNK, SUPPORTED_F, _jac_window,
                          trilerp_rows_plain)


def fused_ray_reduce_plain(table, urows, uid, lf, F: int,
                           with_jac: bool = True, jac_lo: int = 0,
                           jac_hi: int | None = None):
    """Plain PyTorch version of `fused_ray_reduce` (same contract),
    PLAIN_CHUNK cells at a time."""
    Fj = _jac_window(F, jac_lo, jac_hi)
    B, U = urows.shape
    K = uid.shape[1]
    n = B * K
    n_rows = table.shape[0]
    urows_f = urows.reshape(-1).to(torch.int64)
    uid_f = uid.reshape(-1).to(torch.int64)
    lf_f = lf.reshape(8, n)
    feats = torch.empty((F, n), device=table.device)
    jac = torch.empty((3 * Fj, n), device=table.device) if with_jac else None
    for i0 in range(0, n, PLAIN_CHUNK):
        sl = slice(i0, min(i0 + PLAIN_CHUNK, n))
        cells = torch.arange(sl.start, sl.stop, device=table.device)
        u = uid_f[sl]
        r = urows_f[(cells // K) * U + u.clamp(0, U - 1)]
        in_row = (u >= 0) & (u < U) & (r >= 0) & (r < n_rows)
        g = table[r.clamp(0, n_rows - 1)]
        lfc = lf_f[:, sl]
        lfc = torch.cat([torch.where(in_row, lfc[:3], -9.0), lfc[3:]])
        f, j = trilerp_rows_plain(g, lfc, F, with_jac, jac_lo, Fj)
        feats[:, sl] = f.T
        if with_jac:
            jac[:, sl] = j.permute(0, 2, 1).reshape(3 * Fj, -1)
    return (feats.reshape(F, B, K),
            jac.reshape(3 * Fj, B, K) if with_jac else None)


def fused_ray_reduce(table, urows, uid, lf, F: int, with_jac: bool = True,
                     jac_lo: int = 0, jac_hi: int | None = None):
    """Expand unique rows by slot id and trilerp-reduce every cell.

    Args:
      table: (n_rows, W) f32 or bf16 storage table, W >= 27*F.
      urows: (B, U) int32 table row of each unique slot.
      uid: (B, K) int32 slot of each cell in its batch row's U slots.
      lf: (8, B, K) f32 [lx, ly, lz, fx, fy, fz, scale, 0]; a local
        coordinate outside [0, 1] (the -9 overflow marker) zeroes the
        cell.
      F: features per lattice point; jac_lo/jac_hi: jacobian window.

    Returns (feats (F, B, K), jac (3*Fj, B, K) or None), feature-major,
    as ingp_tpu's fused_ray_reduce on g_u = table[urows]."""
    if table.device.type == "cpu":
        return fused_ray_reduce_plain(table, urows, uid, lf, F, with_jac,
                                      jac_lo, jac_hi)
    if table.device.type != "cuda":
        raise ValueError(f"fused_ray_reduce: unsupported device "
                         f"{table.device}")
    Fj = _jac_window(F, jac_lo, jac_hi)
    dev = table.device
    build.check_cuda_tensor("table", table, (torch.float32, torch.bfloat16),
                            2, dev, align=16)
    build.check_cuda_tensor("urows", urows, (torch.int32,), 2, dev)
    build.check_cuda_tensor("uid", uid, (torch.int32,), 2, dev)
    build.check_cuda_tensor("lf", lf, (torch.float32,), 3, dev)
    B, U = urows.shape
    K = uid.shape[1]
    W = table.shape[1]
    if F not in SUPPORTED_F or W < 27 * F or W % 8:
        raise ValueError(f"fused_ray_reduce: unsupported F={F}, W={W}")
    if uid.shape[0] != B or lf.shape != (8, B, K):
        raise ValueError(f"shape mismatch: urows {tuple(urows.shape)}, uid "
                         f"{tuple(uid.shape)}, lf {tuple(lf.shape)}")
    feats = torch.empty((F, B, K), device=dev)
    jac = torch.empty((3 * Fj, B, K), device=dev) if with_jac else None
    if B * K == 0:
        return feats, jac
    with torch.cuda.device(dev):
        build.launch("ingp_ray_reduce_fwd", build.ptr(table),
                     int(table.dtype == torch.bfloat16), table.shape[0],
                     build.ptr(urows), build.ptr(uid), build.ptr(lf),
                     build.ptr(feats), build.ptr(jac), B, K, U, W, F,
                     int(with_jac), jac_lo, Fj, build.stream_of(dev))
    fused_ray_reduce.launches += 1
    return feats, jac


fused_ray_reduce.launches = 0
