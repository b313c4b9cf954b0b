"""K1 split probe: the K1 forward and backward with one piece stubbed at a
time, at the grouped stream's shapes.

The Hopper counterpart of benchmarking/probe_kernel_split.py, which
times the TPU's K1 forward with its weight planes, one-hot expand or
select dot stubbed. Here the pieces are those of the port's K1
(kernels/csrc/rayreduce.cu), all variants template flags of one source,
kernels/csrc/probe_split.cu:

  forward   full (the shipping kernel's body at F = Fj = 8), shipping
            (the shipping kernel itself, `kernels.rayreduce`
            `fused_ray_reduce`, on the same inputs), no-planes (weight 1 and
            the derivative's sign at every corner: no weight build),
            no-expand (every cell reads its batch row's slot-0 row: no
            read by id), no-dot (one corner, not the 8-corner sum; on
            the card this drops the other seven corners' loads too),
            bf16-planes (weights and products in bf16, sums in f32);
            with PROBE_ROWPAIR=1, as the TPU probe: full, rowpair-2 and
            rowpair-4 (2 or 4 batch rows per block).
  backward  full (the shipping kernel's body for a bf16 table: 224
            threads, each cell's lane cotangent and each run's sum
            rounded to bf16), shipping (`fused_ray_reduce_bwd` with
            bf16=True on the same inputs), no-atomics (each run's sum
            stored into a scratch row per (batch row, slot) instead of
            added into the master with atomicAdd), no-planes, walk-1
            (each block walks one cell, not 256: it takes away all
            per-cell work of the other 255 and leaves the launch, the
            block's set-up and one flush), staged (full, after the block
            copies its cells' uid, lf and cotangents into shared memory:
            the same work without a global load inside the walk).

The TPU probe's `factored-E` (point-domain weights expanded to lanes by
an MXU dot) has no counterpart: the CUDA kernel builds each corner's
weight once already.

Shapes are the probe's: T = 768, groups (rows, U) = (3840, 96), (2304,
128), (1536, 176), 256 cells per row, 256-lane rows of F = 8 features,
with the jacobian; the rows come from the bench's bf16 rgb table
(715,199 rows). Every variant runs on two uid inputs: the probe's random
uid (no runs, the worst case for the backward's run flush) and the same
uid sorted along the row (non-decreasing, as the sorted training stream
gives it). lf is uniform in [0, 1) in all 8 planes, as the probe draws
it: every local coordinate truncates to 0, so each cell reads the 8
corner points of its brick's cell (0, 0, 0), which `ingp_local_ok`
accepts.

Run on the card: python -m ingp_tpu_torch.probes.kernel_split
(--device cpu runs the plain versions only).
"""
from __future__ import annotations

import os
import sys

import torch

from ..kernels import build, rayreduce
from ..kernels.brickreduce import (PLAIN_CHUNK, _lane_points, round_bf16,
                                   trilerp_rows_bwd_plain,
                                   trilerp_rows_plain)
from . import common

T_RAYS = 768
GROUPS = ((T_RAYS * 5, 96), (T_RAYS * 3, 128), (T_RAYS * 2, 176))
K, W, F = 256, 256, 8
N_ROWS = 715_199
# mode -> (kernel mode, batch rows per block); "shipping" runs the
# shipping kernel (kernels/rayreduce.py) instead of the split's
FWD_MODES = {"full": (0, 1), "shipping": (None, 1), "no-planes": (1, 1),
             "no-expand": (2, 1), "no-dot": (3, 1), "bf16-planes": (4, 1)}
ROWPAIR_MODES = {"full": (0, 1), "rowpair-2": (0, 2), "rowpair-4": (0, 4)}
BWD_MODES = {"full": 0, "shipping": None, "no-atomics": 1, "no-planes": 2,
             "walk-1": 3, "staged": 4}
UIDS = ("random", "sorted")
_CORNERS = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]


def _fwd_mode(mode):
    return FWD_MODES.get(mode) or ROWPAIR_MODES[mode]


def _check(name, t, dtypes, shape, dev, align=4):
    build.check_cuda_tensor(name, t, dtypes, len(shape), dev, align)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _check_inputs(table, urows, uid, lf, dev):
    B, U = urows.shape
    _check("urows", urows, (torch.int32,), (B, U), dev)
    _check("uid", uid, (torch.int32,), (B, uid.shape[1]), dev)
    _check("lf", lf, (torch.float32,), (8, B, uid.shape[1]), dev)
    if uid.shape[1] > 256:
        raise ValueError(f"K = {uid.shape[1]} > 256 cells per row")
    if table is not None:
        _check("table", table, (torch.bfloat16,), (table.shape[0], W), dev,
               align=16)


def split_fwd(mode: str, table, urows, uid, lf):
    """K1's forward with the piece `mode` stubbed (FWD_MODES,
    ROWPAIR_MODES). table (n_rows, 256) bf16; urows (B, U), uid (B, K)
    int32; lf (8, B, K) f32. Returns (feats (8, B, K), jac (24, B, K))
    f32. CPU tensors run `split_fwd_plain`."""
    if table.device.type == "cpu":
        return split_fwd_plain(mode, table, urows, uid, lf)
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"split_fwd: unsupported device {dev}")
    _check_inputs(table, urows, uid, lf, dev)
    code, per_block = _fwd_mode(mode)
    if code is None:
        return rayreduce.fused_ray_reduce(table, urows, uid, lf, F, True)
    B, U = urows.shape
    Kc = uid.shape[1]
    feats = torch.empty((F, B, Kc), device=dev)
    jac = torch.empty((3 * F, B, Kc), device=dev)
    with torch.cuda.device(dev):
        build.launch("ingp_probe_split_fwd", code, per_block,
                     build.ptr(table), table.shape[0], build.ptr(urows),
                     build.ptr(uid), build.ptr(lf), build.ptr(feats),
                     build.ptr(jac), B, Kc, U, build.stream_of(dev))
    return feats, jac


def _local_ok(loc):
    return ((loc >= 0) & (loc <= 1)).all(0)


def _stub_trilerp(mode, g, lf):
    """The stubbed reduce of rows g (n, W) at lf (8, n): (feats (n, F),
    unscaled jac (3, n, F)) in the kernel's order of operations."""
    n = g.shape[0]
    li = lf[0:3].clamp(0, 1).to(torch.int64)
    fr = lf[3:6]
    pts = g[:, :27 * F].float().reshape(n, 27, F)
    ar = torch.arange(n, device=g.device)
    feats = torch.zeros((n, F), device=g.device)
    jac = torch.zeros((3, n, F), device=g.device)
    for a, b, c in _CORNERS[:1] if mode == "no-dot" else _CORNERS:
        v = pts[ar, 9 * (li[0] + a) + 3 * (li[1] + b) + (li[2] + c)]
        if mode == "no-planes":
            feats += v
            for ax, s in enumerate((a, b, c)):
                jac[ax] = jac[ax] + v if s else jac[ax] - v
            continue
        wx = fr[0] if a else 1.0 - fr[0]
        wy = fr[1] if b else 1.0 - fr[1]
        wz = fr[2] if c else 1.0 - fr[2]
        ws = (wx * wy * wz, (1.0 if a else -1.0) * wy * wz,
              wx * (1.0 if b else -1.0) * wz, wx * wy * (1.0 if c else -1.0))
        if mode == "no-dot":
            feats = ws[0][:, None] * v
            jac = torch.stack([w[:, None] * v for w in ws[1:]])
        else:  # bf16-planes: bf16(bf16(w) * v) summed in f32
            prods = [(w.to(torch.bfloat16)[:, None]
                      * v.to(torch.bfloat16)).float() for w in ws]
            feats += prods[0]
            jac += torch.stack(prods[1:])
    return feats, jac


def split_fwd_plain(mode: str, table, urows, uid, lf):
    """Plain PyTorch version of `split_fwd` (same contract), PLAIN_CHUNK
    cells at a time."""
    _fwd_mode(mode)
    B, U = urows.shape
    Kc = uid.shape[1]
    n = B * Kc
    n_rows = table.shape[0]
    urows_f = urows.reshape(-1).to(torch.int64)
    uid_f = uid.reshape(-1).to(torch.int64)
    lf_f = lf.reshape(8, n)
    feats = torch.empty((F, n), device=table.device)
    jac = torch.empty((3 * F, n), device=table.device)
    for i0 in range(0, n, PLAIN_CHUNK):
        sl = slice(i0, min(i0 + PLAIN_CHUNK, n))
        b = torch.arange(sl.start, sl.stop, device=table.device) // Kc
        u = torch.zeros_like(b) if mode == "no-expand" else uid_f[sl]
        r = urows_f[b * U + u.clamp(0, U - 1)]
        ok = (u >= 0) & (u < U) & (r >= 0) & (r < n_rows)
        g = table[r.clamp(0, n_rows - 1)]
        lfc = lf_f[:, sl]
        lfc = torch.cat([torch.where(ok, lfc[:3], -9.0), lfc[3:]])
        if mode in ("no-planes", "no-dot", "bf16-planes"):
            f, j = _stub_trilerp(mode, g, lfc)
            keep = _local_ok(lfc[0:3])
            f = torch.where(keep[:, None], f, 0.0)
            j = torch.where(keep[None, :, None], j * lfc[6][None, :, None],
                            0.0)
        else:
            f, j = trilerp_rows_plain(g, lfc, F, True)
        feats[:, sl] = f.T
        jac[:, sl] = j.permute(0, 2, 1).reshape(3 * F, -1)
    return feats.reshape(F, B, Kc), jac.reshape(3 * F, B, Kc)


def split_bwd(mode: str, grad, urows, uid, lf, dfeats, djac,
              scratch=None, bf16: bool = False):
    """K1's backward with the piece `mode` stubbed (BWD_MODES), f32
    cotangents; bf16: round each cell's lane cotangent and each run's sum
    to bf16 (the shipping kernel's rounding for a bf16 table). Adds into
    grad (n_rows, 256) f32 in place and returns it; "no-atomics" instead
    stores each run's sum into scratch (B*U, 256) f32 at row b*U + slot
    and returns scratch. uid may have runs in any order (a slot that
    recurs along a row is flushed once per run). CPU tensors run
    `split_bwd_plain`."""
    if grad.device.type == "cpu":
        return split_bwd_plain(mode, grad, urows, uid, lf, dfeats, djac,
                               scratch, bf16)
    dev = grad.device
    if dev.type != "cuda":
        raise ValueError(f"split_bwd: unsupported device {dev}")
    code = BWD_MODES[mode]
    if code is None:
        return rayreduce.fused_ray_reduce_bwd(grad, urows, uid, lf, dfeats,
                                              djac, F, bf16=bf16)
    _check_inputs(None, urows, uid, lf, dev)
    B, U = urows.shape
    Kc = uid.shape[1]
    _check("grad", grad, (torch.float32,), (grad.shape[0], W), dev)
    _check("dfeats", dfeats, (torch.float32,), (F, B, Kc), dev)
    _check("djac", djac, (torch.float32,), (3 * F, B, Kc), dev)
    if mode == "no-atomics":
        _check("scratch", scratch, (torch.float32,), (B * U, W), dev)
    with torch.cuda.device(dev):
        build.launch("ingp_probe_split_bwd", code, int(bf16),
                     build.ptr(grad),
                     build.ptr(scratch if mode == "no-atomics" else None),
                     grad.shape[0], build.ptr(urows), build.ptr(uid),
                     build.ptr(lf), build.ptr(dfeats), build.ptr(djac), B,
                     Kc, U, build.stream_of(dev))
    return scratch if mode == "no-atomics" else grad


def _lane_ct(mode, lfc, df, dj):
    """Per-lane cotangent (n, W) of the cells' rows, as the kernel's
    `ingp_lane_ct`: full planes, or weight 1 and the derivative signs."""
    if mode != "no-planes":
        return trilerp_rows_bwd_plain(lfc, df, dj, F, W)
    li, lj, lk, lane_f = _lane_points(F, W, lfc.device)
    loc = lfc[0:3].clamp(0, 1).to(torch.int64)
    a, b, c = (p[None] - l[:, None] for p, l in zip((li, lj, lk), loc))
    corner = ((a == 0) | (a == 1)) & ((b == 0) | (b == 1)) & \
        ((c == 0) | (c == 1)) & (li >= 0)[None]
    sign = [torch.where(x == 1, 1.0, -1.0) for x in (a, b, c)]
    t = (dj[0][:, lane_f] * sign[0] + dj[1][:, lane_f] * sign[1]) \
        + dj[2][:, lane_f] * sign[2]
    dg = df[:, lane_f] * 1.0 + t * lfc[6][:, None]
    ok = _local_ok(lfc[0:3])
    return torch.where(corner & ok[:, None], dg, 0.0)


def _cells(mode, uid, lf, dfeats, djac):
    """The cells a block walks: all K, or the first one for walk-1."""
    if mode != "walk-1":
        return uid, lf, dfeats, djac
    return (uid[:, :1].contiguous(), lf[:, :, :1].contiguous(),
            dfeats[:, :, :1].contiguous(), djac[:, :, :1].contiguous())


def split_bwd_plain(mode: str, grad, urows, uid, lf, dfeats, djac,
                    scratch=None, bf16: bool = False):
    """Plain PyTorch version of `split_bwd` (same contract): the kernel's
    walk, every batch row at once. Each cell's per-lane cotangent
    (rounded to bf16 with bf16), summed along k into the row's current
    run in cell order; a run ends where a valid cell of another slot
    starts one, and its sum (rounded with bf16) is added into grad at
    the slot's table row, or for no-atomics stored over the slot's
    scratch row on the lanes where it is not zero."""
    BWD_MODES[mode]                 # a KeyError names an unknown mode
    uid, lf, dfeats, djac = _cells(mode, uid, lf, dfeats, djac)
    B, U = urows.shape
    Kc = uid.shape[1]
    n = B * Kc
    dev = grad.device
    n_rows = grad.shape[0]
    u = uid.to(torch.int64)
    valid = (u >= 0) & (u < U) & _local_ok(lf[0:3])
    lf_f = lf.reshape(8, n)
    valid_f = valid.reshape(-1)
    dg = torch.empty((n, W), device=dev)
    for i0 in range(0, n, PLAIN_CHUNK):
        sl = slice(i0, min(i0 + PLAIN_CHUNK, n))
        lfc = lf_f[:, sl]
        lfc = torch.cat([torch.where(valid_f[sl], lfc[:3].trunc(), -9.0),
                         lfc[3:]])
        dg[sl] = _lane_ct(mode, lfc, dfeats.reshape(F, n)[:, sl].T,
                          djac.reshape(3, F, n)[:, :, sl].transpose(1, 2))
    if bf16:
        dg = round_bf16(dg)
    dg = dg.reshape(B, Kc, W)
    row_of = urows.to(torch.int64)
    b_ar = torch.arange(B, device=dev)
    acc = torch.zeros((B, W), device=dev)
    cur = torch.full((B,), -1, dtype=torch.int64, device=dev)

    def flush(ends):
        """Flush the current run of the batch rows where `ends`."""
        val = round_bf16(acc) if bf16 else acc
        slot = cur.clamp(min=0)
        r = row_of[b_ar, slot]
        ok = ends & (r >= 0) & (r < n_rows)
        if mode == "no-atomics":
            s = b_ar * U + slot
            scratch[s] = torch.where(ok[:, None] & (val != 0), val,
                                     scratch[s])
        else:
            grad.index_add_(0, r.clamp(0, n_rows - 1),
                            torch.where(ok[:, None], val, 0.0))

    for k in range(Kc):
        v = valid[:, k]
        new = v & (u[:, k] != cur)
        flush(new & (cur >= 0))
        cur = torch.where(new, u[:, k], cur)
        acc = torch.where(new[:, None], 0.0, acc)
        acc = torch.where(v[:, None], acc + dg[:, k], acc)
    flush(cur >= 0)
    return scratch if mode == "no-atomics" else grad


def make_inputs(gen, device, rows: int, U: int, table, order: str):
    """A group's inputs from `gen`: urows (rows, U) into `table`, the
    probe's uniform uid (or that uid sorted along the row), lf uniform
    in [0, 1) in all 8 planes, f32 cotangents."""
    n_rows = table.shape[0]
    kw = dict(generator=gen, device=device)
    urows = torch.randint(0, n_rows, (rows, U), dtype=torch.int32, **kw)
    uid = torch.randint(0, U, (rows, K), dtype=torch.int32, **kw)
    if order == "sorted":
        uid = uid.sort(1).values.contiguous()
    lf = torch.rand((8, rows, K), **kw)
    dfeats = torch.randn((F, rows, K), **kw)
    djac = torch.randn((3 * F, rows, K), **kw)
    return dict(urows=urows, uid=uid, lf=lf, dfeats=dfeats, djac=djac)


def _point_keys(rows, lf, n_corners):
    """Distinct (row, lattice point) keys of the corners the cells read
    (rows: (cells,) int64 table row or slot of each cell)."""
    loc = lf[0:3].reshape(3, -1).clamp(0, 1).long()
    base = rows * 27
    keys = [base + 9 * (loc[0] + a) + 3 * (loc[1] + b) + (loc[2] + c)
            for a, b, c in _CORNERS[:n_corners]]
    return int(torch.unique(torch.cat(keys)).numel())


def fwd_bytes(mode, inp):
    """(bytes, f32 operations) a forward variant must move and do on
    these inputs: the distinct corner points it reads, the slot ids and
    uid it reads, the lf planes it reads (no-planes needs no fractions),
    and the features and jacobian it writes."""
    urows, uid, lf = inp["urows"], inp["uid"], inp["lf"]
    B, U = urows.shape
    cells = uid.numel()
    b = torch.arange(cells, device=uid.device) // uid.shape[1]
    u = torch.zeros_like(b) if mode == "no-expand" \
        else uid.reshape(-1).long()
    slots = b * U + u
    corners = 1 if mode == "no-dot" else 8
    pts = _point_keys(urows.reshape(-1)[slots].long(), lf, corners)
    planes = 4 if mode == "no-planes" else 7
    nbytes = (pts * F * 2 + int(torch.unique(slots).numel()) * 4
              + (0 if mode == "no-expand" else cells * 4)
              + cells * 4 * planes + cells * 4 * 4 * F)
    return nbytes, cells * corners * 4 * F * 2


def bwd_bytes(mode, inp):
    """(bytes, f32 operations) of a backward variant: ids, lf planes and
    cotangents of the cells walked, the slot ids, and one f32
    read-modify-write of each distinct master address (no-atomics: one
    write of each distinct scratch address)."""
    urows = inp["urows"]
    uid, lf, _, _ = _cells(mode, inp["uid"], inp["lf"], inp["dfeats"],
                           inp["djac"])
    B, U = urows.shape
    cells = uid.numel()
    slots = (torch.arange(cells, device=uid.device) // uid.shape[1]) * U \
        + uid.reshape(-1).long()
    rows = slots if mode == "no-atomics" else urows.reshape(-1)[slots].long()
    pts = _point_keys(rows, lf, 8)
    planes = 4 if mode == "no-planes" else 7
    nbytes = (cells * 4 * (1 + planes + 4 * F)
              + int(torch.unique(slots).numel()) * 4
              + pts * F * (4 if mode == "no-atomics" else 8))
    return nbytes, cells * 8 * (12 + 9 * F)


def cases(device, seed: int = 0, groups=GROUPS, n_rows: int = N_ROWS,
          fwd_modes=None, bwd_modes=None, uids=UIDS) -> list:
    """One `common.Case` per (direction, mode, uid input), each over all
    groups (its time is the sum over the groups, as the TPU probe's)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn((n_rows, W), generator=gen, device=device
                        ).to(torch.bfloat16)
    grad = torch.zeros((n_rows, W), device=device)
    out = []
    for o in uids:
        ins = [make_inputs(gen, device, rows, U, table, o)
               for rows, U in groups]
        out += [_fwd_case(mode, o, table, ins) for mode in
                (list(FWD_MODES) if fwd_modes is None else fwd_modes)]
        slot_rows = [torch.ones((inp["urows"].numel(), W), device=device)
                     for inp in ins]
        out += [_bwd_case(mode, o, grad, ins, slot_rows) for mode in
                (list(BWD_MODES) if bwd_modes is None else bwd_modes)]
    return out


def _fwd_case(mode, order, table, ins):
    symbol = "ingp_ray_reduce_fwd" if mode == "shipping" \
        else "ingp_probe_split_fwd"

    def run(fn):
        return [t for inp in ins for t in fn(mode, table, inp["urows"],
                                             inp["uid"], inp["lf"])]

    sizes = [fwd_bytes(mode, inp) for inp in ins]
    return common.Case(
        "kernel_split", f"fwd {mode}, {order} uid",
        lambda: run(split_fwd), lambda: run(split_fwd_plain),
        lambda: [table.index_select(0, inp["urows"].reshape(-1))
                 for inp in ins],
        "index_select of the unique rows (the gather in front of the "
        "TPU's K1)",
        sum(s[0] for s in sizes), sum(s[1] for s in sizes), "fwd", symbol)


def _bwd_case(mode, order, grad, ins, slot_rows):
    scratch = [torch.zeros((inp["urows"].numel(), W), device=grad.device)
               if mode == "no-atomics" else None for inp in ins]

    def run(fn, fresh):
        """fresh: clear the target first and return a copy of it."""
        res = []
        for inp, s in zip(ins, scratch):
            target = grad if s is None else s
            if fresh:
                target.zero_()
            fn(mode, grad, inp["urows"], inp["uid"], inp["lf"],
               inp["dfeats"], inp["djac"], s, bf16=True)
            res.append(target.clone() if fresh else target)
        return res

    sizes = [bwd_bytes(mode, inp) for inp in ins]
    return common.Case(
        "kernel_split", f"bwd {mode}, {order} uid",
        lambda: run(split_bwd, True), lambda: run(split_bwd_plain, True),
        lambda: [grad.index_add_(0, inp["urows"].reshape(-1), sr)
                 for inp, sr in zip(ins, slot_rows)],
        "index_add_ of the slot rows into the master (the scatter behind "
        "the TPU's K1 bwd)",
        sum(s[0] for s in sizes), sum(s[1] for s in sizes), "bwd",
        "ingp_ray_reduce_bwd" if mode == "shipping"
        else "ingp_probe_split_bwd", timed=lambda: run(split_bwd, False))


# the piece each stub takes away: (direction, stub, piece)
PIECES = (("fwd", "no-planes", "weight build"),
          ("fwd", "no-expand", "read by id"),
          ("fwd", "no-dot", "7 of 8 corners (reads and sums)"),
          ("bwd", "no-atomics", "f32 atomics"),
          ("bwd", "no-planes", "weight build"),
          ("bwd", "walk-1", "per-cell work of cells 2-256"),
          ("bwd", "staged", "global loads inside the walk"))


def piece_shares(ms: dict) -> list:
    """Lines giving the share of the full kernel's time that each piece
    takes, 1 - stub / full, from {variant: ms} of `cases`."""
    lines = []
    for order in UIDS:
        for d in ("fwd", "bwd"):
            full = ms.get(f"{d} full, {order} uid")
            stubs = [(piece, ms.get(f"{d} {stub}, {order} uid"))
                     for dd, stub, piece in PIECES if dd == d]
            parts = [f"{piece} {1 - t / full:+.1%}" for piece, t in stubs
                     if t is not None]
            ship = ms.get(f"{d} shipping, {order} uid")
            if ship is not None:
                parts.append(f"shipping kernel {ship:.4f} ms "
                             f"({ship / full - 1:+.1%} of full)")
            if full and parts:
                lines.append(f"K1 {d} ({order} uid, full {full:.4f} ms): "
                             + ", ".join(parts))
    return lines


def main(argv=None):
    a = common.parse_args(sys.argv[1:] if argv is None else argv, __doc__)
    rowpair = os.environ.get("PROBE_ROWPAIR", "0") == "1"
    fwd_modes = list(ROWPAIR_MODES if rowpair else FWD_MODES)
    res = common.run(cases(a.device, a.seed, fwd_modes=fwd_modes,
                           bwd_modes=[] if rowpair else None), a.device,
                     a.iters)
    for s in piece_shares({c.variant: r["ms"] for c, r in res}):
        print(s, flush=True)


if __name__ == "__main__":
    main()
