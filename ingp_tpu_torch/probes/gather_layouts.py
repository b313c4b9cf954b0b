"""In-block gather probe: the four int32 gathers that the TPU probe asked
Mosaic to lower inside a kernel, and the table gathers and scatter-adds
of its XLA half.

The Hopper counterpart of benchmarking/probe_gather_layouts.py. Its
Pallas kernels (k_sub, k_lane, k_take) become the forms of
kernels/csrc/probe_gather.cu, at the probe's shapes; each asks where a
gathered table should sit on the card:

  axis 0   out[s, c] = table[idx[s, c], c], (512, 128) -> (256, 128) and
           -> (8192, 128): from the L2 below 2048 output rows, from
           16-column slabs staged in shared memory from there on, beside
           the body it replaced ("before": a 32-column slab per block of
           256 rows, 4 blocks at 256 rows);
  axis 1   out[s, c] = table[s, idx[s, c]], (256, 128): a warp-shuffle
           gather of a row held in registers;
  flat     out = table.flat[idx] from 65,536 entries -> (256, 128):
           clusters of 8 blocks each holding the whole table across
           their shared memory and reading it through distributed shared
           memory ("cluster"), the one 2-block cluster it replaced
           ("cluster before"), and a plain device-memory read ("global").

The library yardsticks are `torch.gather` and flat indexing. At these
sizes a call is launch-bound, so each is also timed replayed from a
CUDA graph, without the host's dispatch, beside the launch floor (a
one-element fill from a graph) and the host's dispatch of one call.
`axis0_rows` times the axis-0 body against the one it replaced over row
counts on both sides of its switch to the slab. Its XLA half (2D and 3D
row layouts gathered with `jnp.take`, scatter-adds with `.at[].add`,
sorted or not) runs as `index_select` / `index_add_`
(`library_layouts`).

Run on the card: python -m ingp_tpu_torch.probes.gather_layouts
(--device cpu runs the plain versions only).
"""
from __future__ import annotations

import ctypes
import sys

import torch

from ..kernels import build
from . import common

SYMBOL = "ingp_probe_gather"   # the kernel's launcher
# probe_gather.cu's ops
OPS = {"axis0": 0, "axis1": 1, "cluster": 2, "global": 3,
       "axis0 before": 4, "cluster before": 5}
FLAT_WHERE = ("cluster", "cluster before", "global")
SLAB_FROM_ROWS = 2048   # the axis-0 body's switch (kSlabFromRows)
SLAB_COLS = 16          # its slab's columns (kSlabCols)
FLAT_CLUSTER = 8        # the cluster's blocks (kFlatCluster)
SMEM_MAX = 232_448      # shared bytes a block may hold
# a slab of R rows beside 512 rows of ids; the body it replaced: 32 columns
AXIS0_MAX_ROWS = (SMEM_MAX - 512 * SLAB_COLS * 4) // (SLAB_COLS * 4)
AXIS0_BEFORE_MAX_ROWS = SMEM_MAX // (32 * 4)
FLAT_PART_MAX = (SMEM_MAX - 16) // 4   # entries a cluster block holds
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


def align_of(op: str) -> int:
    """The alignment in bytes that `op` (an OPS key) needs of its table
    and ids: 16 for the kernels that read them with 16-byte copies and
    loads, 4 for the others (probe_gather.cu's align_of)."""
    return 16 if op in ("axis0", "cluster") else 4


def _check(table, idx, name, op, t_ndim=2):
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    build.check_cuda_tensor("table", table, (torch.int32,), t_ndim, dev,
                            align=align_of(op))
    build.check_cuda_tensor("idx", idx, (torch.int32,), 2, dev,
                            align=align_of(op))


def launch_shape(op: str, t_shape, i_shape) -> dict:
    """The launch the kernel makes for `op` (an OPS key) on a table of
    t_shape and ids of i_shape, as probe_gather.cu plans it: grid,
    threads per block, blocks per cluster (1: none) and dynamic shared
    bytes per block. Card only (it asks the built library)."""
    dims = (ctypes.c_int * 5)()
    t_rows, t_cols = (t_shape if len(t_shape) == 2
                      else (1, int(torch.Size(t_shape).numel())))
    rc = build.load_probe_library().ingp_probe_gather_shape(
        OPS[op], t_rows, t_cols, i_shape[0], i_shape[1], dims)
    if rc != 0:
        raise ValueError(f"{op}: no launch for table {tuple(t_shape)}, "
                         f"idx {tuple(i_shape)}")
    return {"grid": (dims[0], dims[1]), "threads": dims[2],
            "cluster": dims[3], "smem": dims[4]}


def describe(shape: dict) -> str:
    gx, gy = shape["grid"]
    s = f"{gx * gy} blocks ({gx} x {gy}) of {shape['threads']} threads"
    if shape["cluster"] > 1:
        s += f" in clusters of {shape['cluster']}"
    return s + f", {shape['smem']} B shared each"


def take_axis0(table, idx, before: bool = False):
    """out[s, c] = table[idx[s, c], c]: table (R, C) int32 with C a
    multiple of 32 and R <= 3120 (a 16-column slab beside 512 rows of ids
    in one block's shared memory), idx (S, C) int32, both 16-byte
    aligned; an id outside [0, R) gives 0. The kernel reads the table
    from the L2 below SLAB_FROM_ROWS output rows and from slabs staged in
    shared memory from there on. `before`: the body it replaced (R <=
    1816, any alignment). CPU tensors run `take_axis0_plain`."""
    if table.device.type == "cpu":
        return take_axis0_plain(table, idx)
    op = "axis0 before" if before else "axis0"
    _check(table, idx, "take_axis0", op)
    R, C = table.shape
    limit = AXIS0_BEFORE_MAX_ROWS if before else AXIS0_MAX_ROWS
    if idx.shape[1] != C or C % 32 or R > limit:
        raise ValueError(f"take_axis0 ({op}): table "
                         f"{tuple(table.shape)}, idx {tuple(idx.shape)}")
    return _launch(op, table, idx, idx.shape, torch.empty_like(idx))


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
    _check(table, idx, "take_axis1", "axis1")
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


def flat_limit(where: str) -> int | None:
    """The most entries `take_flat` takes in place `where` (None: any)."""
    return {"cluster": FLAT_CLUSTER * FLAT_PART_MAX,
            "cluster before": 2 * (SMEM_MAX // 4)}.get(where)


def take_flat(table, idx, where: str = "cluster"):
    """out = table.reshape(-1)[idx] for an int32 table of any shape and
    idx (S, C) int32, read from clusters of 8 blocks holding the table
    across their shared memory ("cluster": at most 8 x 58,108 = 464,864
    entries, table and ids 16-byte aligned), from the one 2-block
    cluster it replaced ("cluster before": an even table of at most
    116,224 entries) or from device memory ("global"); an id outside the
    table gives 0. CPU tensors run `take_flat_plain`."""
    if table.device.type == "cpu":
        return take_flat_plain(table, idx)
    flat = table.reshape(-1)
    if where not in FLAT_WHERE:
        raise ValueError(f"take_flat: no place {where!r}")
    _check(flat, idx, "take_flat", where, t_ndim=1)
    limit = flat_limit(where)
    if (flat.numel() == 0 or (limit is not None and flat.numel() > limit)
            or (where == "cluster before" and flat.numel() % 2)):
        raise ValueError(f"take_flat ({where}): {flat.numel()} entries")
    return _launch(where, flat, idx, idx.shape, torch.empty_like(idx))


def take_flat_plain(table, idx):
    """Plain PyTorch version of `take_flat`."""
    flat = table.reshape(-1)
    i = idx.long()
    ok = (i >= 0) & (i < flat.numel())
    return torch.where(ok, flat[i.clamp(0, flat.numel() - 1)], 0)


def _axis0_label(rows, before=False):
    return f"axis 0{' before' if before else ''}, (512, 128) -> ({rows}, 128)"


def cases(device, seed: int = 0, big_rows: int = 8192) -> list:
    """Every kernel form at the TPU probe's shapes, on its tables (arange)
    and uniform ids: axis 0 and the body it replaced at (256, 128) and
    (big_rows, 128), axis 1, and flat in each place."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def ids(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    table = torch.arange(512 * 128, dtype=torch.int32,
                         device=device).reshape(512, 128)
    tbl = torch.arange(256 * 128, dtype=torch.int32,
                       device=device).reshape(256, 128)
    specs = []
    for rows in (256, big_rows):
        i = ids(512, (rows, 128))
        specs += [(_axis0_label(rows, b),
                   lambda t, i, b=b: take_axis0(t, i, b), take_axis0_plain,
                   lambda t, i: torch.gather(t, 0, i), "torch.gather",
                   "axis0 before" if b else "axis0", table, i)
                  for b in (False, True)]
    specs.append(("axis 1, (256, 128)", take_axis1, take_axis1_plain,
                  lambda t, i: torch.gather(t, 1, i), "torch.gather",
                  "axis1", tbl, ids(128, (256, 128))))
    i_flat = ids(512 * 128, (256, 128))
    specs += [(f"flat {w}, 65536 -> (256, 128)",
               lambda t, i, w=w: take_flat(t, i, w), take_flat_plain,
               lambda t, i: t.reshape(-1)[i], "flat indexing", w, table,
               i_flat) for w in FLAT_WHERE]
    out = []
    for label, fn, plain, lib, lib_name, op, t, i in specs:
        i64 = i.long()
        out.append(common.Case(
            "gather_layouts", label, lambda f=fn, t=t, i=i: f(t, i),
            lambda f=plain, t=t, i=i: f(t, i),
            lambda f=lib, t=t, i=i64: f(t, i), lib_name,
            t.numel() * 4 + 2 * i.numel() * 4, 0, "equal", SYMBOL,
            graph=True,
            launch=lambda op=op, t=t, i=i: launch_shape(op, t.shape,
                                                        i.shape)))
    return out


def before_after(results) -> list[str]:
    """One line per shape whose form has a "before" body: its graph and
    host ms and host dispatch against the new body's, the library call's,
    the launch floor and the bound, and the two launches. `results`:
    [(case, numbers)] as `common.run` returns them."""
    by = {c.variant: (c, r) for c, r in results}
    lines = []
    for label, (c_old, old) in by.items():
        if " before," not in label:
            continue
        c_new, new = by[label.replace(" before,", ",")]
        lines.append(
            f"before/after {c_new.probe} [{c_new.variant}]: graph "
            f"{old['graph_ms']:.4f} -> {new['graph_ms']:.4f} ms "
            f"({old['graph_ms'] / new['graph_ms']:.2f}x), host "
            f"{old['ms']:.4f} -> {new['ms']:.4f} ms, host dispatch "
            f"{old['dispatch_ms']:.4f} -> {new['dispatch_ms']:.4f} ms; "
            f"library {c_new.library_name} {new['library_graph_ms']:.4f} ms "
            f"(graph), floor {new['floor_ms']:.4f} ms, bound "
            f"{new['bound_ms']:.4f} ms; launch "
            f"{describe(c_old.launch())} -> {describe(c_new.launch())}")
    return lines


def shifted(x):
    """A contiguous copy of x whose data starts 4 bytes into its storage
    (4-byte aligned, never 16)."""
    flat = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:]
    return flat.reshape(x.shape)


def edge_checks(device, seed: int = 7) -> list[tuple]:
    """The gathers beyond the probe's shapes, each held bitwise to its
    plain version (raises AssertionError on a mismatch): both axis-0
    bodies at ragged row counts on both sides of the switch to the slab
    and at the largest table each takes, every flat place at the largest
    table it takes and at a ragged table and id count, the ops that take
    4-byte-aligned tensors on views 4 bytes into their storage, ids
    outside the table throughout. Returns each checked launch as (op,
    table shape, ids shape)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    checked = []

    def ids(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    def check(op, got, ref, t, i):
        if not torch.equal(got, ref):
            raise AssertionError(f"{op} on table {tuple(t.shape)}, ids "
                                 f"{tuple(i.shape)}: not bitwise equal "
                                 f"to its plain version")
        checked.append((op, tuple(t.shape), tuple(i.shape)))

    def arange(n, shape=None):
        t = torch.arange(1, n + 1, dtype=torch.int32, device=device)
        return t if shape is None else t.reshape(shape)

    def axis0(t, i, before):
        check("axis0 before" if before else "axis0",
              take_axis0(t, i, before), take_axis0_plain(t, i), t, i)

    table = arange(512 * 128, (512, 128))
    for S in (1, 257, 1000, SLAB_FROM_ROWS - 1, SLAB_FROM_ROWS + 1, 5000):
        i = ids(-2, 514, (S, 128))
        for before in (False, True):
            axis0(table, i, before)
    for R, before in ((AXIS0_MAX_ROWS, False),
                      (AXIS0_BEFORE_MAX_ROWS, True)):
        t = arange(R * 32, (R, 32))
        for S in (5, SLAB_FROM_ROWS + 3):
            axis0(t, ids(-2, R + 2, (S, 32)), before)
    for where in FLAT_WHERE:
        limit = flat_limit(where) or 1_000_003
        for T, shape in ((limit, (256, 128)),
                         (65_537 - (where == "cluster before"), (37, 3))):
            flat = arange(T)
            i = ids(-3, T + 3, shape)
            check(where, take_flat(flat, i, where), take_flat_plain(flat, i),
                  flat, i)
    # 4 bytes into their storage: the ops that take any int32 pointer
    t, i = shifted(table), shifted(ids(-2, 514, (257, 128)))
    axis0(t, i, True)
    t1, i1 = shifted(table[:257]), shifted(ids(-2, 130, (257, 128)))
    check("axis1", take_axis1(t1, i1), take_axis1_plain(t1, i1), t1, i1)
    flat = shifted(arange(65_536))
    for where in ("cluster before", "global"):
        check(where, take_flat(flat, i, where), take_flat_plain(flat, i),
              flat, i)
    return checked


def axis0_rows(device, seed: int = 0,
               rows=(256, 1024, SLAB_FROM_ROWS - 1, SLAB_FROM_ROWS, 4096,
                     8192)) -> list[str]:
    """The axis-0 body and the one it replaced at each row count from a
    CUDA graph, each held bitwise to the plain version, beside
    `torch.gather`: on both sides of SLAB_FROM_ROWS the L2 and the slab
    should take about the same time."""
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    table = torch.arange(512 * 128, dtype=torch.int32,
                         device=device).reshape(512, 128)
    lines = []
    for s in rows:
        i = torch.randint(0, 512, (s, 128), generator=gen, device=device,
                          dtype=torch.int32)
        ref = take_axis0_plain(table, i)
        ms = {}
        for before in (False, True):
            if not torch.equal(take_axis0(table, i, before), ref):
                raise AssertionError(f"axis 0 (before={before}) at {s} "
                                     f"rows: not bitwise equal to its "
                                     f"plain version")
            ms["before" if before else "axis0"] = common.graph_ms(
                lambda b=before: take_axis0(table, i, b))
        i64 = i.long()
        ms["torch.gather"] = common.graph_ms(
            lambda: torch.gather(table, 0, i64))
        body = "slab" if s >= SLAB_FROM_ROWS else "l2"
        lines.append(f"axis 0 rows, (512, 128) -> ({s}, 128), {body}, "
                     f"graph ms: " + ", ".join(f"{b} {t:.4f}"
                                              for b, t in ms.items()))
    return lines


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
    results = common.run(cases(a.device, a.seed), a.device, a.iters)
    if a.device.type == "cuda":
        for line in before_after(results) + axis0_rows(a.device, a.seed):
            print(line, flush=True)
        library_layouts(a.device, a.seed)


if __name__ == "__main__":
    main()
