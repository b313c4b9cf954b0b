"""K1: fused unique-row expand + trilerp reduce of the stream encoder.

Replaces the forward of ingp_tpu/ops/pallas/rayreduce_pallas.py
`fused_ray_reduce`. The TPU kernel expands unique rows, gathered
beforehand into a (B, U, W) block, with a one-hot MXU matmul (Mosaic has
no vector gather); the CUDA kernel (`csrc/rayreduce.cu`) takes the
storage table and the unique rows' table ids and reads each cell's row
by index, so the block never exists. It is bound by bytes moved (see
the source's note).

The backward (`fused_ray_reduce_bwd`, `csrc/rayreduce.cu`) replaces
`_frr_bwd` of rayreduce_pallas.py without its one-hot MXU transpose:
per batch row it sums each run of cells that share a unique slot (the
grouped plan's slot ids never decrease along a row) in cell order and
adds the slot's row into the f32 master gradient at its table row. The
kernel computes every cell's lane cotangents in parallel and sums all
runs of a row in parallel (see the source's note). `RayReduceFn` binds
forward and backward into a `torch.autograd.Function`.
"""
from __future__ import annotations

import torch

from . import build
from .brickreduce import (PLAIN_CHUNK, SUPPORTED_F, _jac_window,
                          round_bf16, trilerp_rows_bwd_plain,
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
    return feats, jac


def fused_ray_reduce_bwd_plain(grad, urows, uid, lf, dfeats, djac, F: int,
                               jac_lo: int = 0, jac_hi: int | None = None,
                               bf16: bool = False):
    """Plain PyTorch version of `fused_ray_reduce_bwd` (same contract):
    per-cell cotangents, summed per unique slot in cell order, then the
    slots' rows added into `grad` in slot order."""
    Fj = _jac_window(F, jac_lo, jac_hi)
    B, U = urows.shape
    K = uid.shape[1]
    n = B * K
    n_rows, W = grad.shape
    uid_f = uid.reshape(-1).to(torch.int64)
    lf_f = lf.reshape(8, n)
    df_f = dfeats.reshape(F, n)
    dj_f = None if djac is None else djac.reshape(3, Fj, n)
    slots = torch.zeros((B * U, W), device=grad.device)
    for i0 in range(0, n, PLAIN_CHUNK):
        sl = slice(i0, min(i0 + PLAIN_CHUNK, n))
        cells = torch.arange(sl.start, sl.stop, device=grad.device)
        u = uid_f[sl]
        in_row = (u >= 0) & (u < U)
        lfc = lf_f[:, sl]
        lfc = torch.cat([torch.where(in_row, lfc[:3], -9.0), lfc[3:]])
        dg = trilerp_rows_bwd_plain(
            lfc, df_f[:, sl].T, None if dj_f is None else
            dj_f[:, :, sl].transpose(1, 2), F, W, jac_lo, Fj)
        if bf16:
            dg = round_bf16(dg)
        slots.index_add_(0, (cells // K) * U + u.clamp(0, U - 1), dg)
    if bf16:
        slots = round_bf16(slots)
    r = urows.reshape(-1).to(torch.int64)
    in_table = (r >= 0) & (r < n_rows)
    grad.index_add_(0, r.clamp(0, n_rows - 1),
                    torch.where(in_table[:, None], slots, 0.0))
    return grad


def fused_ray_reduce_bwd(grad, urows, uid, lf, dfeats, djac, F: int,
                         jac_lo: int = 0, jac_hi: int | None = None,
                         bf16: bool = False):
    """Backward of `fused_ray_reduce`: add each unique slot's row
    cotangent into the f32 master gradient `grad` at `urows[b, u]`, in
    place.

    Args:
      grad: (n_rows, W) f32, accumulated into.
      urows, uid, lf, F, jac_lo, jac_hi: as given to `fused_ray_reduce`;
        uid must not decrease along a row (the grouped plan's clipped
        running count), so that the cells of a slot form one run.
      dfeats: (F, B, K) f32 cotangent of feats; djac: (3*Fj, B, K) f32
        cotangent of jac, or None (no jacobian in the forward).
      bf16: round each cell's per-lane cotangent to bfloat16, sum a
        slot's cells in f32 and round the slot's row to bfloat16 before
        the f32 add into the master -- the rounding points of
        rayreduce_pallas.py `_bwd_kernel` on a bf16 block with one
        k-slab, and of the bf16 gather cotangent behind it.

    Cells marked -9 and cells whose uid lies outside [0, U) add exactly
    nothing. Returns grad."""
    if grad.device.type == "cpu":
        return fused_ray_reduce_bwd_plain(grad, urows, uid, lf, dfeats,
                                          djac, F, jac_lo, jac_hi, bf16)
    if grad.device.type != "cuda":
        raise ValueError(f"fused_ray_reduce_bwd: unsupported device "
                         f"{grad.device}")
    Fj = _jac_window(F, jac_lo, jac_hi)
    dev = grad.device
    # 16-byte rows: the kernel adds each lattice point's F lanes with
    # vector atomics
    build.check_cuda_tensor("grad", grad, (torch.float32,), 2, dev, align=16)
    build.check_cuda_tensor("urows", urows, (torch.int32,), 2, dev)
    build.check_cuda_tensor("uid", uid, (torch.int32,), 2, dev)
    build.check_cuda_tensor("lf", lf, (torch.float32,), 3, dev)
    build.check_cuda_tensor("dfeats", dfeats, (torch.float32,), 3, dev)
    B, U = urows.shape
    K = uid.shape[1]
    W = grad.shape[1]
    if F not in SUPPORTED_F or W < 27 * F or W % 4:
        raise ValueError(f"fused_ray_reduce_bwd: unsupported F={F}, W={W}")
    if (uid.shape[0] != B or lf.shape != (8, B, K)
            or dfeats.shape != (F, B, K)):
        raise ValueError(f"shape mismatch: urows {tuple(urows.shape)}, uid "
                         f"{tuple(uid.shape)}, lf {tuple(lf.shape)}, "
                         f"dfeats {tuple(dfeats.shape)}")
    if djac is not None:
        build.check_cuda_tensor("djac", djac, (torch.float32,), 3, dev)
        if djac.shape != (3 * Fj, B, K):
            raise ValueError(f"djac shape {tuple(djac.shape)}")
    if B * K == 0:
        return grad
    with torch.cuda.device(dev):
        build.launch("ingp_ray_reduce_bwd", build.ptr(grad), grad.shape[0],
                     build.ptr(urows), build.ptr(uid), build.ptr(lf),
                     build.ptr(dfeats), build.ptr(djac), B, K, U, W, F,
                     int(djac is not None), jac_lo, Fj, int(bf16),
                     build.stream_of(dev))
    return grad


class RayReduceFn(torch.autograd.Function):
    """`fused_ray_reduce` on a table read (ops/gather.py `TableRead`),
    differentiable w.r.t. the f32 master table behind it.

    Inputs: the read's token, its gradient sink, the storage table that
    the forward kernel reads, and the `fused_ray_reduce` arguments. The
    backward runs `fused_ray_reduce_bwd` into the sink's accumulator;
    urows, uid and lf get no gradient (as `_frr_bwd` returns zeros for
    lf)."""

    @staticmethod
    def forward(ctx, token, sink, storage, urows, uid, lf, F, with_jac,
                jac_lo, jac_hi):
        feats, jac = fused_ray_reduce(storage, urows, uid, lf, F, with_jac,
                                      jac_lo, jac_hi)
        ctx.save_for_backward(urows, uid, lf)
        ctx.cfg = (sink, F, jac_lo, jac_hi,
                   storage.dtype == torch.bfloat16)
        if jac is None:
            return feats, feats.new_empty(0)
        return feats, jac

    @staticmethod
    def backward(ctx, dfeats, djac):
        urows, uid, lf = ctx.saved_tensors
        sink, F, jac_lo, jac_hi, bf16 = ctx.cfg
        dj = djac.contiguous() if djac.numel() else None
        fused_ray_reduce_bwd(sink.buffer(), urows, uid, lf,
                             dfeats.contiguous(), dj, F, jac_lo, jac_hi,
                             bf16)
        return (sink.token_grad(),) + (None,) * 9


def ray_reduce(read, urows, uid, lf, F: int, with_jac: bool = True,
               jac_lo: int = 0, jac_hi: int | None = None):
    """`fused_ray_reduce` on a table read (ops/gather.py `table_read`):
    through `RayReduceFn` when the read carries a gradient token, else
    straight on its storage."""
    if read.token is None:
        return fused_ray_reduce(read.storage, urows, uid, lf, F, with_jac,
                                jac_lo, jac_hi)
    feats, jac = RayReduceFn.apply(read.token, read.sink, read.storage,
                                   urows, uid, lf, F, with_jac, jac_lo,
                                   jac_hi)
    return feats, (jac if with_jac else None)
