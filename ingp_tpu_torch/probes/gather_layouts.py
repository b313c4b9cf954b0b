"""In-block gather probe: the four int32 gathers that the TPU probe asked
Mosaic to lower inside a kernel, and the table gathers and scatter-adds
of its XLA half.

The Hopper counterpart of benchmarking/probe_gather_layouts.py. Its
Pallas kernels (k_sub, k_lane, k_take) become the four forms of
kernels/csrc/probe_gather.cu, at the probe's shapes:

  axis 0   out[s, c] = table[idx[s, c], c], (512, 128) -> (256, 128) and
           -> (8192, 128): 32-column slabs of the table in shared memory;
  axis 1   out[s, c] = table[s, idx[s, c]], (256, 128): a warp-shuffle
           gather of a row held in registers;
  flat     out = table.flat[idx] from 65,536 entries -> (256, 128): a
           2-block cluster holding one half of the table each, reading
           the other half through distributed shared memory ("cluster"),
           timed against a plain device-memory read ("global").

The library yardsticks are `torch.gather` and flat indexing. At these
sizes a call is launch-bound, so each is also timed replayed from a
CUDA graph, without the host's dispatch. Its XLA
half (2D and 3D row layouts gathered with `jnp.take`, scatter-adds with
`.at[].add`, sorted or not) runs as `index_select` / `index_add_`
(`library_layouts`).

Run on the card: python -m ingp_tpu_torch.probes.gather_layouts
(--device cpu runs the plain versions only).
"""
from __future__ import annotations

import sys

import torch

from ..kernels import build
from . import common

SYMBOL = "ingp_probe_gather"   # the kernel's launcher
OPS = {"axis0": 0, "axis1": 1, "cluster": 2, "global": 3}
N = 3_145_728           # the XLA half's fetches (K=196608 x L=16)
ROWS = 180_000


def _launch(op, table, idx, i_shape, out):
    dev = table.device
    with torch.cuda.device(dev):
        build.launch(SYMBOL, OPS[op], build.ptr(table),
                     table.shape[0] if table.ndim == 2 else 1,
                     table.shape[-1], build.ptr(idx), build.ptr(out),
                     i_shape[0], i_shape[1], build.stream_of(dev))
    return out


def _check(table, idx, name, t_ndim=2):
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    build.check_cuda_tensor("table", table, (torch.int32,), t_ndim, dev)
    build.check_cuda_tensor("idx", idx, (torch.int32,), 2, dev)


def take_axis0(table, idx):
    """out[s, c] = table[idx[s, c], c]: table (R, C) int32 with C a
    multiple of 32 and R <= 1816 (a 32-column slab in one block's shared
    memory), idx (S, C) int32; an id outside [0, R) gives 0. CPU tensors
    run `take_axis0_plain`."""
    if table.device.type == "cpu":
        return take_axis0_plain(table, idx)
    _check(table, idx, "take_axis0")
    R, C = table.shape
    if idx.shape[1] != C or C % 32 or R * 32 * 4 > 232_448:
        raise ValueError(f"take_axis0: table {tuple(table.shape)}, idx "
                         f"{tuple(idx.shape)}")
    return _launch("axis0", table, idx, idx.shape, torch.empty_like(idx))


def take_axis0_plain(table, idx):
    """Plain PyTorch version of `take_axis0`."""
    i = idx.long()
    ok = (i >= 0) & (i < table.shape[0])
    return torch.where(ok, torch.gather(table, 0, i.clamp(
        0, table.shape[0] - 1)), 0)


def take_axis1(table, idx):
    """out[s, c] = table[s, idx[s, c]]: table and idx (S, 128) int32; an
    id outside [0, 128) gives 0. CPU tensors run `take_axis1_plain`."""
    if table.device.type == "cpu":
        return take_axis1_plain(table, idx)
    _check(table, idx, "take_axis1")
    if table.shape[1] != 128 or idx.shape != table.shape:
        raise ValueError(f"take_axis1: table {tuple(table.shape)}, idx "
                         f"{tuple(idx.shape)}")
    return _launch("axis1", table, idx, idx.shape, torch.empty_like(idx))


def take_axis1_plain(table, idx):
    """Plain PyTorch version of `take_axis1`."""
    i = idx.long()
    ok = (i >= 0) & (i < table.shape[1])
    return torch.where(ok, torch.gather(table, 1, i.clamp(
        0, table.shape[1] - 1)), 0)


def take_flat(table, idx, where: str = "cluster"):
    """out = table.reshape(-1)[idx] for an int32 table of any shape and
    idx (S, C) int32, read from a 2-block cluster's shared memory
    ("cluster": an even table of at most 116,224 entries) or from device
    memory ("global"); an id outside the table gives 0. CPU tensors run
    `take_flat_plain`."""
    if table.device.type == "cpu":
        return take_flat_plain(table, idx)
    flat = table.reshape(-1)
    _check(flat, idx, "take_flat", t_ndim=1)
    if where == "cluster" and (flat.numel() % 2
                               or flat.numel() * 2 > 232_448):
        raise ValueError(f"take_flat: {flat.numel()} entries for a "
                         f"2-block cluster")
    return _launch(where, flat, idx, idx.shape, torch.empty_like(idx))


def take_flat_plain(table, idx):
    """Plain PyTorch version of `take_flat`."""
    flat = table.reshape(-1)
    i = idx.long()
    ok = (i >= 0) & (i < flat.numel())
    return torch.where(ok, flat[i.clamp(0, flat.numel() - 1)], 0)


def cases(device, seed: int = 0, big_rows: int = 8192) -> list:
    """The five kernel forms at the TPU probe's shapes, on its tables
    (arange) and uniform ids."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def ids(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    table = torch.arange(512 * 128, dtype=torch.int32,
                         device=device).reshape(512, 128)
    tbl = torch.arange(256 * 128, dtype=torch.int32,
                       device=device).reshape(256, 128)
    specs = (
        ("axis 0, (512, 128) -> (256, 128)", take_axis0, take_axis0_plain,
         lambda t, i: torch.gather(t, 0, i), "torch.gather", table,
         ids(512, (256, 128))),
        (f"axis 0, (512, 128) -> ({big_rows}, 128)", take_axis0,
         take_axis0_plain, lambda t, i: torch.gather(t, 0, i),
         "torch.gather", table, ids(512, (big_rows, 128))),
        ("axis 1, (256, 128)", take_axis1, take_axis1_plain,
         lambda t, i: torch.gather(t, 1, i), "torch.gather", tbl,
         ids(128, (256, 128))),
    )
    i_flat = ids(512 * 128, (256, 128))
    specs += tuple(
        (f"flat {w}, 65536 -> (256, 128)",
         lambda t, i, w=w: take_flat(t, i, w), take_flat_plain,
         lambda t, i: t.reshape(-1)[i], "flat indexing", table, i_flat)
        for w in ("cluster", "global"))
    out = []
    for label, fn, plain, lib, lib_name, t, i in specs:
        i64 = i.long()
        out.append(common.Case(
            "gather_layouts", label, lambda f=fn, t=t, i=i: f(t, i),
            lambda f=plain, t=t, i=i: f(t, i),
            lambda f=lib, t=t, i=i64: f(t, i), lib_name,
            t.numel() * 4 + 2 * i.numel() * 4, 0, "equal", SYMBOL,
            graph=True))
    return out


def library_layouts(device, seed: int = 0, n: int = N, rows: int = ROWS,
                    iters: int = 6):
    """The TPU probe's XLA half as library calls: 2D and 3D row layouts
    gathered with `index_select`, and scatter-adds into f32 tables with
    `index_add_` (3D tile, 2D, and 3D after sorting the ids)."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    idx = torch.randint(0, rows, (n,), generator=gen, device=device)

    def report(what, ms, nbytes, n_i):
        print(f"library {what}: {ms:8.3f} ms ({nbytes / ms / 1e6:6.1f} GB/s "
              f"useful, {ms * 1e6 / n_i:5.2f} ns/idx)", flush=True)

    for inner, dtype, n_i in (((512,), torch.bfloat16, n),
                              ((2048,), torch.bfloat16, n // 4),
                              ((512,), torch.float32, n // 2),
                              ((16, 128), torch.bfloat16, n // 4),
                              ((8, 128), torch.float32, n // 4),
                              ((32, 128), torch.bfloat16, n // 8),
                              ((16, 256), torch.bfloat16, n // 8),
                              ((8, 128), torch.bfloat16, n // 4)):
        tb = torch.zeros((rows,) + inner, dtype=dtype, device=device)
        ii = idx[:n_i]
        ms = common.time_ms(lambda: tb.index_select(0, ii), iters, device)
        report(f"index_select {(rows,) + inner} "
               f"{str(dtype).replace('torch.', '')}", ms,
               n_i * tb[0].numel() * tb.element_size(), n_i)
        del tb
    ns = n // 8
    i4 = idx[:ns]
    for label, inner in (("3D tile (16,128)", (16, 128)), ("2D 512", (512,))):
        ct = torch.ones((ns,) + inner, device=device)
        ms = common.time_ms(lambda: torch.zeros(
            (rows,) + inner, device=device).index_add_(0, i4, ct), iters,
            device)
        report(f"index_add_ f32 {label}, {ns} rows", ms, ct.numel() * 4, ns)
    ct = torch.ones((ns, 16, 128), device=device)

    def sorted_add():
        i_s, order = torch.sort(i4)
        return torch.zeros((rows, 16, 128), device=device).index_add_(
            0, i_s, ct.index_select(0, order))

    ms = common.time_ms(sorted_add, iters, device)
    report(f"sort + index_add_ f32 3D tile (16,128), {ns} rows", ms,
           ct.numel() * 4, ns)


def main(argv=None):
    a = common.parse_args(sys.argv[1:] if argv is None else argv, __doc__)
    common.run(cases(a.device, a.seed), a.device, a.iters)
    if a.device.type == "cuda":
        library_layouts(a.device, a.seed)


if __name__ == "__main__":
    main()
