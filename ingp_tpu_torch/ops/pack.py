"""Bit packing and fixed-shape sample compaction (counterpart of
ingp_tpu/ops/pack.py).

Bit words are int32 tensors that hold the uint32 bit patterns of the
JAX package's words (torch's uint32 support is partial): shifting right
and masking with 1 reads the same bit either way.

Compaction keeps the JAX semantics exactly: when the batch overflows K,
the kept samples are the first K valid cells in sample-major order
(index s*R + r), and they are packed ray-major (index r*S + s), so each
ray's samples sit contiguously and t-ordered in the compact batch --
the order the stream-dedup encoder relies on.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 tensor of values in [0, 2^32) -> int32 with the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words
                       ).to(torch.int32)


def packbits_u32(density_grid: torch.Tensor, threshold) -> torch.Tensor:
    """(M,) density -> (M//32,) int32 bit words; bit i of word w is cell
    w*32+i (ingp_tpu/ops/pack.py:44)."""
    occ = (density_grid.reshape(-1, 32) > threshold).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=occ.device)
    return as_int32_bits((occ << shifts).sum(1))


def bitfield_lookup(bitfield: torch.Tensor, idx: torch.Tensor):
    """Occupancy bits of cells `idx` (any shape, int) -> bool."""
    idx = idx.to(torch.int64)
    word = bitfield[idx >> 5]
    return ((word >> (idx & 31).to(word.dtype)) & 1).bool()


class CompactPlan(NamedTuple):
    """Bijective index maps between valid (R, S) cells and (K,) slots."""
    src: torch.Tensor         # (K,) ray-major flat cell index per slot
    slot_valid: torch.Tensor  # (K,) slot holds a real sample
    slot_grid: torch.Tensor   # (R, S) compact slot per cell
    cell_valid: torch.Tensor  # (R, S) cell is valid AND kept
    n_valid: torch.Tensor     # () kept sample count


def compact_samples(valid: torch.Tensor, capacity: int) -> CompactPlan:
    """Plan the pack of valid (R, S) cells into a fixed (K,) batch
    (ingp_tpu/ops/pack.py:73)."""
    R, S = valid.shape
    K = capacity
    dev = valid.device
    flat_sm = valid.T.reshape(-1)
    inc_sm = torch.cumsum(flat_sm.to(torch.int64), 0)
    n_valid_all = inc_sm[-1] if inc_sm.numel() else inc_sm.new_zeros(())
    kept = (flat_sm & (inc_sm - 1 < K)).reshape(S, R).T

    flat = kept.reshape(-1)
    inc = torch.cumsum(flat.to(torch.int64), 0)
    src = torch.full((K + 1,), S * R, dtype=torch.int64, device=dev)
    cells = torch.nonzero(flat).squeeze(1)
    src[inc[cells] - 1] = cells
    src = src[:K]
    n_valid = torch.clamp(n_valid_all, max=K)
    slot_valid = torch.arange(K, device=dev) < n_valid
    slot_grid = (inc - 1).reshape(R, S)
    return CompactPlan(src, slot_valid, slot_grid, kept, n_valid)


def gather_samples(arr: torch.Tensor, plan: CompactPlan):
    """(R, S, ...) -> compact (K, ...); padding slots are zeros."""
    R, S = plan.slot_grid.shape
    flat = arr.reshape((R * S,) + arr.shape[2:])
    out = flat[torch.clamp(plan.src, max=R * S - 1)]
    mask = plan.slot_valid.reshape((-1,) + (1,) * (arr.ndim - 2))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def scatter_back(values: torch.Tensor, plan: CompactPlan):
    """Compact (K, ...) -> (R, S, ...); unmapped cells are zeros
    (a gather through the inverse map, as in the JAX package)."""
    R, S = plan.slot_grid.shape
    K = values.shape[0]
    tail = values.shape[1:]
    safe = torch.clamp(plan.slot_grid, max=K - 1).reshape(-1)
    out = values[safe].reshape((R, S) + tail)
    mask = plan.cell_valid.reshape((R, S) + (1,) * len(tail))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def ray_ids_for(plan: CompactPlan):
    """Ray index of each compact slot (ray-major flattening)."""
    R, S = plan.slot_grid.shape
    return torch.div(torch.clamp(plan.src, max=R * S - 1), S,
                     rounding_mode="floor")


def gather_samples_cm(arr: torch.Tensor, plan: CompactPlan):
    """(C, R, S) -> compact (C, K); padding slots are zeros."""
    C = arr.shape[0]
    R, S = plan.slot_grid.shape
    out = arr.reshape(C, R * S)[:, torch.clamp(plan.src, max=R * S - 1)]
    return torch.where(plan.slot_valid[None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def scatter_back_cm(values: torch.Tensor, plan: CompactPlan):
    """Compact (C, K) -> (C, R, S); unmapped cells are zeros."""
    R, S = plan.slot_grid.shape
    C, K = values.shape
    safe = torch.clamp(plan.slot_grid, max=K - 1).reshape(-1)
    out = values[:, safe].reshape(C, R, S)
    return torch.where(plan.cell_valid[None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))
