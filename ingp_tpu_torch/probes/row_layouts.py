"""Row-gather probe: gathering whole table rows by id, at the row widths
and layouts of the TPU probe.

The Hopper counterpart of benchmarking/probe_row_layouts.py. Its Pallas
half (`pallas_probe`: a per-row DMA gather, 8 copies in flight, 512 rows
per grid step) becomes `row_gather`, one bulk asynchronous copy per row
into shared memory with 8 in flight per block (kernels/csrc/
probe_rows.cu), at the probe's three cases:

  (256,) bf16 rows (512 B) from 715,199 rows, n = 2^20;
  (16, 128) bf16 rows (4 KiB) from 178,800 rows, n = 2^18;
  (8, 128) f32 rows (4 KiB) from 178,800 rows, n = 2^18.

Its XLA half (`xla_probe`: `t.at[i].get` and `.at[i].add` into an f32
table at ten row layouts, 512 MB of useful rows each) becomes the
library calls `t[i]` and `index_add_`, timed beside it. On the card a
row is a row: the (8, 128) and (16, 128) tiles of the TPU's layouts
are only their row width here.

Run on the card: python -m ingp_tpu_torch.probes.row_layouts
(--device cpu runs the plain versions only).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..kernels import build
from . import common

# (inner row shape, dtype, n gathered, table rows), probe_row_layouts.py
SYMBOL = "ingp_probe_row_gather"   # the kernel's launcher
CASES = (((256,), torch.bfloat16, 1 << 20, 715_199),
         ((16, 128), torch.bfloat16, 1 << 18, 178_800),
         ((8, 128), torch.float32, 1 << 18, 178_800))
# the XLA half's layouts: (label, inner row shape, dtype)
LAYOUTS = (("256 f32  [base]", (256,), torch.float32),
           ("256 bf16 [base]", (256,), torch.bfloat16),
           ("1024 f32 flat", (1024,), torch.float32),
           ("(8,128) f32 tile", (8, 128), torch.float32),
           ("2048 bf16 flat", (2048,), torch.bfloat16),
           ("(16,128) bf16 tile", (16, 128), torch.bfloat16),
           ("(16,128) f32 2tile", (16, 128), torch.float32),
           ("(32,128) bf16 2tile", (32, 128), torch.bfloat16),
           ("512 bf16 flat", (512,), torch.bfloat16),
           ("(16,256) bf16 2tile", (16, 256), torch.bfloat16))
USEFUL = 512 << 20      # useful gathered bytes per layout
TABLE_BYTES = 768 << 20


def row_gather(table, idx):
    """out[j] = table[idx[j]] for a table (n_rows, ...) of rows of 16 to
    6144 bytes (a multiple of 16) and int32 ids (n,); an id outside
    [0, n_rows) gives a zero row. CPU tensors run `row_gather_plain`."""
    if table.device.type == "cpu":
        return row_gather_plain(table, idx)
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {dev}")
    row_bytes = table[0].numel() * table.element_size()
    build.check_cuda_tensor("table", table, (table.dtype,), table.ndim, dev,
                            align=16)
    build.check_cuda_tensor("idx", idx, (torch.int32,), 1, dev)
    if row_bytes % 16 or not 16 <= row_bytes <= 6144:
        raise ValueError(f"row_gather: rows of {row_bytes} bytes")
    out = torch.empty((idx.shape[0],) + tuple(table.shape[1:]),
                      dtype=table.dtype, device=dev)
    with torch.cuda.device(dev):
        build.launch(SYMBOL, build.ptr(table),
                     table.shape[0], row_bytes, build.ptr(idx),
                     build.ptr(out), idx.shape[0], build.stream_of(dev))
    return out


def row_gather_plain(table, idx):
    """Plain PyTorch version of `row_gather` (same contract)."""
    i = idx.to(torch.int64)
    ok = (i >= 0) & (i < table.shape[0])
    rows = table[i.clamp(0, table.shape[0] - 1)]
    return torch.where(ok.reshape((-1,) + (1,) * (table.ndim - 1)), rows,
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))


def _label(inner, dtype):
    return f"{inner} {str(dtype).replace('torch.', '')}"


def cases(device, seed: int = 0, shapes=CASES) -> list:
    """One `common.Case` per row layout of the TPU probe's Pallas half."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for inner, dtype, n, n_rows in shapes:
        table = torch.randn((n_rows,) + inner, generator=gen,
                            device=device).to(dtype)
        idx = torch.randint(0, n_rows, (n,), generator=gen, device=device,
                            dtype=torch.int32)
        row_bytes = int(np.prod(inner)) * table.element_size()
        out.append(common.Case(
            "row_layouts", _label(inner, dtype),
            lambda t=table, i=idx: row_gather(t, i),
            lambda t=table, i=idx: row_gather_plain(t, i),
            lambda t=table, i=idx: t[i], "t[i]",
            n * 4 + 2 * n * row_bytes, 0, "equal", SYMBOL, rows=n,
            row_bytes=row_bytes))
    return out


def library_layouts(device, seed: int = 0, layouts=LAYOUTS,
                    useful=USEFUL, table_bytes=TABLE_BYTES, iters=8):
    """The TPU probe's XLA half as library calls: `t[i]` and `index_add_`
    of the rows into an f32 table of the same layout, at constant useful
    bytes. Prints ns/row and useful GB/s of each."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for label, inner, dtype in layouts:
        vals = int(np.prod(inner))
        bytes_per = vals * torch.tensor([], dtype=dtype).element_size()
        rows = max(table_bytes // bytes_per, 1024)
        n = max(useful // bytes_per, 1024)
        t = torch.randn((rows,) + inner, generator=gen, device=device
                        ).to(dtype)
        i = torch.randint(0, rows, (n,), generator=gen, device=device)
        d_g = common.time_ms(lambda: t[i], iters, device)
        tz = torch.zeros((rows,) + inner, device=device)
        v = torch.randn((n,) + inner, generator=gen, device=device
                        ).to(dtype).float()
        d_s = common.time_ms(lambda: tz.index_add_(0, i, v), iters, device)
        print(f"library {label:22s} rows {rows:8d} n {n:8d}  t[i] "
              f"{d_g * 1e6 / n:7.2f} ns/row {n * bytes_per / d_g / 1e6:6.1f}"
              f" GB/s   index_add_ f32 {d_s * 1e6 / n:7.2f} ns/row "
              f"{n * vals * 4 / d_s / 1e6:6.1f} GB/s (useful)", flush=True)
        del t, tz, v, i


def main(argv=None):
    a = common.parse_args(sys.argv[1:] if argv is None else argv, __doc__)
    common.run(cases(a.device, a.seed), a.device, a.iters)
    if a.device.type == "cuda":
        library_layouts(a.device, a.seed)


if __name__ == "__main__":
    main()
