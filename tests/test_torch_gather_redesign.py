"""The redesigned in-block gathers of the probe (ingp_tpu_torch/kernels/
csrc/probe_gather.cu), as numpy models of the CUDA kernels, on the CPU.

Axis 0, out[s, c] = table[idx[s, c], c]: a thread takes 4 adjacent
columns of one output row (a 16-byte id load and store). Below
SLAB_FROM_ROWS output rows the grid is flat, a thread per 4-column group
reading the table from the L2 (axis0_l2_kernel); from there on a block
(slab x, chunk y) of 512 threads stages a slab of 16 columns and its
chunk's ids, and serves 512 output rows of it, thread t on column group
t % 4 of row t // 4 plus multiples of 128 (axis0_slab_kernel). The body
they replaced (axis0_before_kernel): a block (32 columns, 256 rows), a
warp per row, a lane per column. Each model must cover every output
exactly once and agree with `take_axis0_plain` and with
`np.take_along_axis`, the TPU probe's own reference.

Flat, out = table.flat[idx]: clusters of 8 blocks of 64 threads; block
rank r holds entries [r * part, r * part + part), part = ceil(T / 8)
rounded up to 4 entries; block b serves the 4-id groups b * 64 + t plus
multiples of the grid's threads, and block 0 the last M % 4 ids
(flat_cluster_kernel). The model must read every id from the right
rank's part, serve every id exactly once, and agree with
`take_flat_plain` and the probe's `table.reshape(-1)[idx]`.

`plan` mirrors probe_gather.cu's plan_of (the launch of each op); the
card tests hold it to the library's `ingp_probe_gather_shape`.
"""
import contextlib

import numpy as np
import pytest
import torch

from ingp_tpu_torch.kernels import build
from ingp_tpu_torch.probes import gather_layouts as pg
from tests._torch_threads import one_torch_thread  # noqa: F401

L2_THREADS, SLAB_THREADS, SLAB_ROWS = 256, 512, 512
FLAT_THREADS, FLAT_MAX_BLOCKS = 64, 1056
ROWS_BEFORE, COLS_BEFORE, THREADS_BEFORE = 256, 32, 1024


def cdiv(a, b):
    return -(-a // b)


def plan(op, t_shape, i_shape):
    """probe_gather.cu's plan_of: {grid, threads, cluster, smem} (and
    the flat part), or None where the op does not take the shapes."""
    t_rows, t_cols = t_shape if len(t_shape) == 2 else (1, t_shape[0])
    S, C = i_shape
    M, T = S * C, t_rows * t_cols
    p = {"grid": (1, 1), "threads": 256, "cluster": 1, "smem": 0}
    if op in ("axis0", "axis0 before"):
        limit = (pg.AXIS0_BEFORE_MAX_ROWS if op == "axis0 before"
                 else pg.AXIS0_MAX_ROWS)
        if t_cols != C or C % 32 or t_rows > limit:
            return None
        if op == "axis0 before":
            p.update(grid=(C // COLS_BEFORE, cdiv(S, ROWS_BEFORE)),
                     smem=t_rows * COLS_BEFORE * 4)
        elif S >= pg.SLAB_FROM_ROWS:
            p.update(grid=(C // pg.SLAB_COLS, cdiv(S, SLAB_ROWS)),
                     threads=SLAB_THREADS,
                     smem=(SLAB_ROWS + t_rows) * pg.SLAB_COLS * 4)
        else:
            p.update(grid=(cdiv(M // 4, L2_THREADS), 1),
                     threads=L2_THREADS)
        return p
    if op == "axis1":
        if t_cols != 128 or C != 128 or t_rows != S:
            return None
        return dict(p, grid=(cdiv(S, 8), 1))
    if op == "global":
        return dict(p, grid=(cdiv(M, 256), 1))
    if op == "cluster before":
        if T % 2 or T // 2 * 4 > pg.SMEM_MAX:
            return None
        return dict(p, grid=(2, 1), threads=THREADS_BEFORE, cluster=2,
                    smem=T // 2 * 4)
    cs = pg.FLAT_CLUSTER
    if cdiv(T, cs) > pg.FLAT_PART_MAX:
        return None
    part = cdiv(cdiv(T, cs), 4) * 4
    clusters = min(cdiv(cdiv(M, 4 * FLAT_THREADS), cs),
                   FLAT_MAX_BLOCKS // cs)
    return dict(p, grid=(clusters * cs, 1), threads=FLAT_THREADS,
                cluster=cs, smem=part * 4, part=part)


# ---------------------------------------------------------- axis 0 model

def _axis0_threads(body, S, C):
    """Every (block, thread, step) of one body's launch as flat arrays:
    the output row s and first column c it writes, and how many adjacent
    columns (4, or 1 for the body replaced); inactive slots dropped."""
    if body == "l2":
        gx = cdiv(S * C // 4, L2_THREADS)
        g = np.arange(gx * L2_THREADS)
        g = g[g < S * C // 4]
        return g // (C // 4), g % (C // 4) * 4, 4
    if body == "slab":
        groups = pg.SLAB_COLS // 4         # 4-column groups of a slab row
        step = SLAB_THREADS // groups      # rows a step of the block covers
        bx, by, t, k = np.meshgrid(
            np.arange(C // pg.SLAB_COLS), np.arange(cdiv(S, SLAB_ROWS)),
            np.arange(SLAB_THREADS), np.arange(SLAB_ROWS // step),
            indexing="ij")
        s = by * SLAB_ROWS + t // groups + k * step
        c = bx * pg.SLAB_COLS + 4 * (t % groups)
        return s[s < S], c[s < S], 4
    # before: a warp per row (8 warps stepping over 256 rows), a lane per
    # column of the block's 32
    bx, by, t, j = np.meshgrid(
        np.arange(C // COLS_BEFORE), np.arange(cdiv(S, ROWS_BEFORE)),
        np.arange(256), np.arange(ROWS_BEFORE // 8), indexing="ij")
    s = by * ROWS_BEFORE + t // 32 + 8 * j
    c = bx * COLS_BEFORE + t % 32
    return s[s < S], c[s < S], 1


def model_axis0(table, idx, body):
    """One body's output and the count of writes of each output."""
    R, C = table.shape
    S = idx.shape[0]
    s, c, width = _axis0_threads(body, S, C)
    out = np.full((S, C), -7, np.int32)
    writes = np.zeros((S, C), np.int64)
    for j in range(width):
        v = idx[s, c + j]
        ok = (v >= 0) & (v < R)
        out[s, c + j] = np.where(ok, table[np.clip(v, 0, R - 1), c + j], 0)
        np.add.at(writes, (s, c + j), 1)
    return out, writes


def _axis0_case(S, seed=0, oob=False):
    rng = np.random.default_rng(seed)
    table = np.arange(512 * 128, dtype=np.int32).reshape(512, 128)
    idx = rng.integers(-3 if oob else 0, 515 if oob else 512,
                       (S, 128)).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("S", [1, 256, 1000, 8192])
@pytest.mark.parametrize("body", ["l2", "slab", "before"])
def test_axis0_model_covers_every_output_once(S, body):
    table, idx = _axis0_case(S, seed=S)
    out, writes = model_axis0(table, idx, body)
    assert (writes == 1).all()
    ref = np.take_along_axis(table, idx, 0)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        out, pg.take_axis0_plain(torch.from_numpy(table),
                                 torch.from_numpy(idx)).numpy())


@pytest.mark.parametrize("S", [1, 256, 1000, 2047, 2048, 3072, 8192])
def test_axis0_grid_and_switch(S):
    """The kernel reads the L2 below SLAB_FROM_ROWS rows and the slab
    from there on; at the probe's R = 512 a chunk's slab holds as many
    bytes (512 x 16 x 4) as the chunk writes; at the probe's shapes the
    launch has at least 32 blocks, where the body it replaced had 4 at
    256 rows."""
    p = plan("axis0", (512, 128), (S, 128))
    gx, gy = p["grid"]
    if S < pg.SLAB_FROM_ROWS:
        assert p["smem"] == 0 and gx == cdiv(S * 32, 256) and gy == 1
    else:
        # a block stages its chunk's 512 rows of ids beside the 512-row
        # slab, whose bytes equal those the chunk writes
        assert (gx, gy) == (128 // pg.SLAB_COLS, cdiv(S, 512))
        assert p["smem"] == 2 * SLAB_ROWS * pg.SLAB_COLS * 4
    if S in (256, 8192):
        assert gx * gy >= 32
    assert plan("axis0 before", (512, 128), (256, 128))["grid"] == (4, 1)


@pytest.mark.parametrize("op,limit", [("axis0", 3120),
                                      ("axis0 before", 1816)])
def test_axis0_row_limit(op, limit):
    """The shipped body's 16-column slab beside 512 rows of ids fits a
    block's 227 KB up to R = 3120, above the 1816 rows of the body it
    replaced, whose 32-column slab stands alone."""
    assert (pg.AXIS0_MAX_ROWS if op == "axis0"
            else pg.AXIS0_BEFORE_MAX_ROWS) == limit
    for S in (5, 4096):
        p = plan(op, (limit, 64), (S, 64))
        assert p is not None and p["smem"] <= pg.SMEM_MAX
        assert plan(op, (limit + 1, 64), (S, 64)) is None


@pytest.mark.parametrize("body", ["l2", "slab", "before"])
def test_axis0_model_gives_zeros_outside_the_table(body):
    table, idx = _axis0_case(2100, seed=5, oob=True)
    table = table + 1   # no 0 in the table
    out, _ = model_axis0(table, idx, body)
    bad = (idx < 0) | (idx >= 512)
    assert bad.any() and not out[bad].any() and out[~bad].all()
    np.testing.assert_array_equal(
        out, pg.take_axis0_plain(torch.from_numpy(table),
                                 torch.from_numpy(idx)).numpy())


# ------------------------------------------------------------ flat model

def model_flat(table, idx):
    """The kernel's output, the count of serves of each id and, per id,
    the rank whose part it read and the cluster of the block that served
    it: (out, serves, rank, cluster)."""
    flat = table.reshape(-1)
    T, M = flat.size, idx.size
    ids = idx.reshape(-1)
    p = plan("cluster", (T,), idx.shape)
    cs, part, blocks = p["cluster"], p["part"], p["grid"][0]
    G, stride = M // 4, blocks * FLAT_THREADS
    # every (block, thread, pass) of the strided loop over 4-id groups
    b, t, it = np.meshgrid(np.arange(blocks), np.arange(FLAT_THREADS),
                           np.arange(max(1, cdiv(G, stride))),
                           indexing="ij")
    g = (b * FLAT_THREADS + t + it * stride).ravel()
    live = g < G
    g, b = g[live], b.ravel()[live]
    j = np.concatenate([(4 * g[:, None] + np.arange(4)).ravel(),
                        np.arange(4 * G, M)])   # block 0: the tail
    server = np.concatenate([np.repeat(b, 4), np.zeros(M - 4 * G, int)])
    serves = np.bincount(j, minlength=M)
    cluster = np.zeros(M, int)
    cluster[j] = server // cs
    ok = (ids >= 0) & (ids < T)
    rank = np.where(ok, ids // part, -1)
    # block rank r's part: entries [r * part, min(r * part + part, T))
    parts = [flat[r * part:min(r * part + part, T)] for r in range(cs)]
    assert all(len(x) <= pg.FLAT_PART_MAX for x in parts)
    out = np.zeros(M, np.int32)
    for r in range(cs):
        sel = rank == r
        out[sel] = parts[r][ids[sel] - r * part]
    return out.reshape(idx.shape), serves, rank, cluster


def _flat_case(T, shape, seed=0, oob=False):
    rng = np.random.default_rng(seed)
    table = np.arange(1, T + 1, dtype=np.int32)
    lo, hi = (-4, T + 4) if oob else (0, T)
    return table, rng.integers(lo, hi, shape).astype(np.int32)


@pytest.mark.parametrize("T", [65_536, "limit", 65_537])
def test_flat_model_partition(T):
    T = pg.flat_limit("cluster") if T == "limit" else T
    table, idx = _flat_case(T, (256, 128), seed=1)
    out, serves, rank, cluster = model_flat(table, idx)
    assert (serves == 1).all()
    assert set(np.unique(rank)) == set(range(pg.FLAT_CLUSTER))
    p = plan("cluster", (T,), idx.shape)
    assert p["smem"] <= pg.SMEM_MAX - 16
    # the probe's 32,768 ids fill 128 blocks: 16 clusters, each serving
    # 256 x 8 consecutive ids
    assert p["grid"][0] == 128
    np.testing.assert_array_equal(cluster, np.arange(idx.size) //
                                  (256 * pg.FLAT_CLUSTER))
    np.testing.assert_array_equal(out, table.reshape(-1)[idx])
    np.testing.assert_array_equal(
        out, pg.take_flat_plain(torch.from_numpy(table),
                                torch.from_numpy(idx)).numpy())
    np.testing.assert_array_equal(out, np.take(table, idx))


@pytest.mark.parametrize("shape", [(1, 1), (37, 3), (4096, 129)])
def test_flat_model_ragged_id_counts(shape):
    """M % 4 ids left over go to block 0; a grid capped at 1056 blocks
    strides over the rest."""
    table, idx = _flat_case(100_003, shape, seed=2, oob=True)
    out, serves, _, _ = model_flat(table, idx)
    assert (serves == 1).all()
    p = plan("cluster", (table.size,), shape)
    assert p["grid"][0] % pg.FLAT_CLUSTER == 0
    assert p["grid"][0] <= FLAT_MAX_BLOCKS
    bad = (idx < 0) | (idx >= table.size)
    assert not out[bad].any() and out[~bad].all()
    np.testing.assert_array_equal(
        out, pg.take_flat_plain(torch.from_numpy(table),
                                torch.from_numpy(idx)).numpy())


def test_flat_limits():
    """A cluster of 8 blocks holds 8 x 58,108 entries (a block's 227 KB
    less the mbarrier); the body it replaced an even table of 2 x
    58,112."""
    assert pg.flat_limit("cluster") == 8 * 58_108 == 464_864
    assert pg.flat_limit("cluster before") == 116_224
    assert pg.flat_limit("global") is None
    assert plan("cluster", (464_864,), (2, 2)) is not None
    assert plan("cluster", (464_865,), (2, 2)) is None
    assert plan("cluster before", (116_226,), (2, 2)) is None


# ------------------------------------------- wrappers: no CPU fallback

class _RefusingLibrary:
    """Stands in for the kernel library: every launch is refused with
    cudaErrorInvalidValue (1)."""

    def ingp_probe_gather(self, *args):
        return 1


def _off_the_cpu(monkeypatch, library):
    """Let the wrappers take meta tensors as if they lay on the card."""
    monkeypatch.setattr(build, "load_probe_library", lambda: library)
    monkeypatch.setattr(build, "stream_of", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for name in ("take_axis0_plain", "take_axis1_plain", "take_flat_plain"):
        monkeypatch.setattr(pg, name, lambda *a: pytest.fail("fell back"))


_CALLS = {
    "axis0": lambda t, i: pg.take_axis0(t, i),
    "axis0 before": lambda t, i: pg.take_axis0(t, i, True),
    "axis1": lambda t, i: pg.take_axis1(t[:256], i),
    "cluster": lambda t, i: pg.take_flat(t, i),
    "cluster before": lambda t, i: pg.take_flat(t, i, "cluster before"),
    "global": lambda t, i: pg.take_flat(t, i, "global"),
}


@pytest.mark.parametrize("call", ["axis0", "axis1", "cluster"])
def test_refused_launch_raises_without_fallback(monkeypatch, call):
    """A wrapper given a tensor off the CPU launches its kernel or
    raises: a refused launch raises, counts no launch and never runs the
    plain version."""
    _off_the_cpu(monkeypatch, _RefusingLibrary())
    monkeypatch.setattr(pg, "_check", lambda *a, **k: None)
    table = torch.empty((512, 128), dtype=torch.int32, device="meta")
    idx = torch.empty((256, 128), dtype=torch.int32, device="meta")
    n0 = build.LAUNCHES[pg.SYMBOL]
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        _CALLS[call](table, idx)
    assert build.LAUNCHES[pg.SYMBOL] == n0


class _OnTheCard:
    """Stands in for a tensor on the card."""
    device = torch.device("cuda", 0)


@pytest.mark.parametrize("op", sorted(pg.OPS))
def test_only_the_vector_kernels_ask_16_byte_alignment(monkeypatch, op):
    """The axis-0 and cluster kernels read their table and ids with
    16-byte copies and loads, so their wrappers hold both to 16 bytes;
    the others (axis 1, global and the bodies replaced) take any int32
    tensor, as the launcher's align_of does. (The card tests run views
    4 bytes into their storage through each op.)"""
    want = 16 if op in ("axis0", "cluster") else 4
    assert pg.align_of(op) == want
    asked = []
    monkeypatch.setattr(
        build, "check_cuda_tensor",
        lambda name, t, dtypes, ndim, dev, align=4: asked.append(
            (name, align)))
    pg._check(_OnTheCard(), _OnTheCard(), op, op)
    assert asked == [("table", want), ("idx", want)]
    src = next(p for p in build.sources("probes")
               if p.name == "probe_gather.cu")
    assert ("return op == AXIS0 || op == FLAT_CLUSTER ? 16 : 4;"
            in src.read_text())


@pytest.mark.parametrize("variant", ["sync", "relaxed", "split",
                                     "relaxed, ex"])
def test_cluster_barrier_variants_apply_to_the_kernel(variant):
    """probes/cluster_barrier.py rebuilds probe_gather.cu with the flat
    cluster's last barrier in other forms by replacing text of the
    kernel: each replacement still finds its text once, and only the
    shipped form keeps the release `cluster.sync()` at the kernel's
    end."""
    from ingp_tpu_torch.probes import cluster_barrier as cb
    shipped = (build.CSRC / "probe_gather.cu").read_text()
    src = cb.source(variant)
    assert (src == shipped) == (variant == "sync")
    assert ("blocks read it" in src) == (variant == "sync")
    assert ("arrive.relaxed" in src) == variant.startswith("relaxed")
    assert ("arrive.release" in src) == (variant == "split")
    assert ("cudaLaunchKernelEx" in src) == (variant == "relaxed, ex")
    with pytest.raises(SystemExit):
        cb.main(["--device", "cpu"])
