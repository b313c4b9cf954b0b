"""On-chip gather probe: row reads from a table that stays on the chip.

The Hopper counterpart of benchmarking/probe_vmem_gather.py, which read
196,608 rows, 256 per grid step, from an (8192, 256) f32 table resident
in the TPU's VMEM (and found it slower than XLA's HBM gather). An SM
gives a block at most 227 KB of shared memory, so the probe's 8 MiB
table cannot sit there; `gather_rows` (kernels/csrc/probe_onchip.cu)
answers two questions instead:

  (a) "l2":   the probe's (8192, 256) table, which stays in the 50 MB L2
              once read, gathered through a ring of shared-memory stages
              by 1-D bulk copies (TMA), a row in and a tile of 8 rows
              out per copy;
  (b) "smem": the largest f32 (rows, 256) table one block can hold, 227
              rows, copied into shared memory once by a persistent block
              per SM, gathered by the same 196,608 ids drawn below 227;
              timed against the same small table read through "l2".

The library yardstick is `index_select`. `write_floor` times what the
card takes to write the output at all: a `zero_()` of it and a
same-size device-to-device `copy_`, from CUDA graphs.

Run on the card: python -m ingp_tpu_torch.probes.vmem_gather
(--device cpu runs the plain versions only).
"""
from __future__ import annotations

import sys

import torch

from ..kernels import build
from . import common

ROWS, W = 8192, 256     # the probe's table (its 17,408 rows cut to 8192)
SYMBOL = "ingp_probe_onchip_gather"   # the kernel's launcher
N = 196_608             # rows gathered
SMEM_ROWS = 227         # 227 rows x 1 KiB = 232,448 B, one block's limit
WHERE = {"l2": 0, "smem": 1}
RING_ROW_BYTES = 28_672  # the largest row the L2 form's ring stages


def gather_rows(table, idx, where: str = "l2"):
    """out[j] = table[idx[j]] for an f32 table (n_rows, W), W a multiple
    of 4, read through the L2 ("l2": W * 4 at most RING_ROW_BYTES) or
    from shared memory ("smem", at most 232,448 bytes of table); an id
    outside [0, n_rows) gives a zero row. CPU tensors run `gather_rows_plain`."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {dev}")
    build.check_cuda_tensor("table", table, (torch.float32,), 2, dev,
                            align=16)
    build.check_cuda_tensor("idx", idx, (torch.int32,), 1, dev)
    n_rows, w = table.shape
    if where not in WHERE:
        raise ValueError(f"gather_rows: no form {where!r}")
    if w % 4 or (where == "smem" and n_rows * w * 4 > 232_448) or (
            where == "l2" and w * 4 > RING_ROW_BYTES):
        raise ValueError(f"gather_rows: table {tuple(table.shape)} for "
                         f"{where}")
    out = torch.empty((idx.shape[0], w), device=dev)
    with torch.cuda.device(dev):
        build.launch(SYMBOL, WHERE[where],
                     build.ptr(table), n_rows, w, build.ptr(idx),
                     build.ptr(out), idx.shape[0], build.stream_of(dev))
    return out


def gather_rows_plain(table, idx):
    """Plain PyTorch version of `gather_rows` (same contract)."""
    i = idx.to(torch.int64)
    ok = (i >= 0) & (i < table.shape[0])
    return torch.where(ok[:, None], table[i.clamp(0, table.shape[0] - 1)],
                       0.0)


def cases(device, seed: int = 0, rows: int = ROWS, n: int = N,
          smem_rows: int = SMEM_ROWS) -> list:
    """(a) the probe's table through the L2; (b) the 227-row table from
    shared memory and through the L2. Each also from a CUDA graph
    (`common.Case.graph`)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    big = torch.randn((rows, W), generator=gen, device=device)
    small = torch.randn((smem_rows, W), generator=gen, device=device)
    i_big = torch.randint(0, rows, (n,), generator=gen, device=device,
                          dtype=torch.int32)
    i_small = torch.randint(0, smem_rows, (n,), generator=gen,
                            device=device, dtype=torch.int32)
    out = []
    for label, t, i, where in (
            (f"(a) l2, ({rows}, {W}) f32", big, i_big, "l2"),
            (f"(b) smem, ({smem_rows}, {W}) f32", small, i_small, "smem"),
            (f"(b) l2, ({smem_rows}, {W}) f32", small, i_small, "l2")):
        out.append(common.Case(
            "vmem_gather", label,
            lambda t=t, i=i, w=where: gather_rows(t, i, w),
            lambda t=t, i=i: gather_rows_plain(t, i),
            lambda t=t, i=i: t.index_select(0, i), "index_select",
            t.numel() * 4 + n * 4 + n * W * 4, 0, "equal", SYMBOL, rows=n,
            row_bytes=W * 4, graph=True))
    return out


def write_floor(device, seed: int = 0, n: int = N) -> dict:
    """What the card takes to write the (n, W) f32 output at all, from
    CUDA graphs (`common.graph_ms`): {"zero_ms": a `zero_()` of it,
    "copy_ms": a device-to-device `copy_` of a same-size tensor into
    it}. Card only."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n, W), device=device)
    src = torch.randn((n, W), generator=gen, device=device)
    return {"zero_ms": common.graph_ms(out.zero_),
            "copy_ms": common.graph_ms(lambda: out.copy_(src))}


def floor_lines(results, floor: dict) -> list:
    """Lines setting each "(a) l2" variant's CUDA-graph time beside the
    library call's, the bound and the write floor (`write_floor`);
    results: [(case, numbers)] of `common.measure`."""
    lines = []
    for c, r in results:
        if not c.variant.startswith("(a) l2,"):
            continue
        g, b = r["graph_ms"], r["bound_ms"]
        lines.append(
            f"vmem_gather write floor [{c.variant}]: graph {g:.4f} ms, "
            f"index_select {r['library_graph_ms']:.4f} ms; bound {b:.4f} ms "
            f"(at {b / g:.1%}); zero_ {floor['zero_ms']:.4f} ms, copy_ "
            f"{floor['copy_ms']:.4f} ms (the gather at "
            f"{g / floor['zero_ms']:.3f}x the zero_)")
    return lines


def main(argv=None):
    a = common.parse_args(sys.argv[1:] if argv is None else argv, __doc__)
    res = common.run(cases(a.device, a.seed), a.device, a.iters)
    if a.device.type == "cuda":
        for line in floor_lines(res, write_floor(a.device, a.seed)):
            print(line, flush=True)


if __name__ == "__main__":
    main()
