"""The order of operations of the redesigned K1 backward and the data
movement of the redesigned K2 forward, as numpy models of the CUDA
kernels (ingp_tpu_torch/kernels/csrc/rayreduce.cu ray_reduce_bwd_kernel,
brickreduce.cu brick_reduce_fwd_kernel), on the CPU.

K1 backward: a block takes one batch row, 256 cells (a chunk) at a time;
(1) every cell's 8*F lane cotangents are computed on their own, rounded
to bf16 in the bf16 variant; (2) runs start at a valid cell whose uid
differs from the previous valid cell's (-9 cells and uids outside
[0, U) are skipped and break no run); (3) each (run, lattice point)
sums the F lanes of its point over the run's cells in k order, a run
that reaches a chunk's end carrying its partial sums into the next
chunk, and flushes once (rounded to bf16 in the bf16 variant). The
model must give `fused_ray_reduce_bwd_plain`'s bits exactly (atol 0),
f32 and bf16, on plans from `ops/streambrick.py`
`_unique_plan_uniform`: a slot's sum in another order could round to
another bf16 value.

K2 forward: a block owns S samples x all Lw levels, stages its inputs
level-major, computes level-fastest into shared memory in the output's
order and writes each output slab with 16-byte stores from the slab's
first 16-byte boundary (scalar head and tail). The model moves the
plain version's per-cell values through the same index arithmetic and
must land every value where `brick_reduce_plain` puts it, for ragged
tiles, Lw that does not divide 256 and jacobian planes whose length is
no multiple of 4; the staged inputs' level stride must put a warp's 32
reads in 32 banks when Lw divides 32.
"""
import numpy as np
import pytest
import torch

from ingp_tpu_torch.kernels import brickreduce as k2
from ingp_tpu_torch.kernels import rayreduce as k1
from ingp_tpu_torch.ops.streambrick import _unique_plan_uniform
from tests._torch_threads import one_torch_thread  # noqa: F401

CHUNK = 256          # rayreduce.cu kBwdThreads: cells a block stages at once
K2_THREADS = 256     # brickreduce.cu kK2Threads: cells per K2 tile

f32 = np.float32


def _bf16(x):
    return k1.round_bf16(torch.from_numpy(np.asarray(x, f32))).numpy()


# ------------------------------------------------------- K1 backward model

def _axis(a, fr):
    """ingp_axis_w: (1 - f) or f, and -1 or +1."""
    return (fr if a else f32(1) - fr), f32(1 if a else -1)


def cell_cotangents(lf_cell, df_cell, dj_cell, F, jac_lo, Fj, bf16):
    """Step 1 for one cell: (8, F) lane cotangents of its corners c =
    4a + 2b + e, as ingp_point_planes / ingp_lane_ct round them."""
    fx, fy, fz, sc = (f32(v) for v in lf_cell[3:7])
    out = np.zeros((8, F), f32)
    for c in range(8):
        a, b, e = c >> 2, (c >> 1) & 1, c & 1
        wx, dwx = _axis(a, fx)
        wy, dwy = _axis(b, fy)
        wz, dwz = _axis(e, fz)
        pyz = f32(wy * wz)
        w = f32(wx * pyz)
        d1 = f32(dwx * pyz)
        d2 = f32(dwy * f32(wx * wz))
        d3 = f32(dwz * f32(wx * wy))
        for f in range(F):
            v = f32(df_cell[f] * w)
            if dj_cell is not None and jac_lo <= f < jac_lo + Fj:
                o = f - jac_lo
                t = f32(f32(f32(dj_cell[o] * d1) + f32(dj_cell[Fj + o] * d2))
                        + f32(dj_cell[2 * Fj + o] * d3))
                v = f32(v + f32(t * sc))
            out[c, f] = _bf16(v) if bf16 else v
    return out


def chunk_runs(u, valid, prev_vuid):
    """Step 2 for one chunk: (starts, cont, last valid uid). A run starts
    at a valid cell whose uid differs from the previous valid cell's
    (prev_vuid: the last valid uid before the chunk, -1 for none); cont:
    the chunk opens inside the run carried from the last chunk (start 0
    is then prepended for it)."""
    starts, last, first_flag = [], prev_vuid, None
    for k in np.flatnonzero(valid):
        flag = u[k] != last
        if first_flag is None:
            first_flag = flag
        if flag:
            starts.append(int(k))
        last = u[k]
    cont = prev_vuid >= 0 and not first_flag
    return ([0] if cont else []) + starts, cont, int(last)


def model_k1_bwd(n_rows, W, urows, uid, lf, df, dj, F, jac_lo=0, Fj=None,
                 bf16=False, chunk=CHUNK):
    """The redesigned K1 backward's order of operations; flushes are
    added into grad in the order the kernel issues them (one block after
    another), which for distinct target rows is any order."""
    Fj = F if Fj is None else Fj
    B, U = urows.shape
    K = uid.shape[1]
    grad = np.zeros((n_rows, W), f32)
    q = np.arange(27 * F)
    p, fq = q // F, q % F
    pi, pj, pk = p // 9, (p // 3) % 3, p % 3

    def flush(b, u, acc):
        if not 0 <= u < U:
            return
        r = urows[b, u]
        if not 0 <= r < n_rows:
            return
        live = acc != 0
        grad[r, q[live]] += (_bf16(acc) if bf16 else acc)[live]

    for b in range(B):
        prev_vuid, carry = -1, None
        for k0 in range(0, K, chunk):
            kc = min(chunk, K - k0)
            last_chunk = k0 + kc >= K
            u = uid[b, k0:k0 + kc]
            loc = lf[0:3, b, k0:k0 + kc]
            valid = (u >= 0) & (u < U) & ((loc >= 0) & (loc <= 1)).all(0)
            locc = np.where(valid, (loc[0].astype(int) << 2)
                            | (loc[1].astype(int) << 1) | loc[2].astype(int),
                            -1)
            ct = np.zeros((kc, 8, F), f32)
            for k in np.flatnonzero(valid):
                ct[k] = cell_cotangents(
                    lf[:, b, k0 + k], df[:, b, k0 + k],
                    None if dj is None else dj[:, b, k0 + k], F, jac_lo, Fj,
                    bf16)
            starts, cont, last_uid = chunk_runs(u, valid, prev_vuid)
            if prev_vuid >= 0 and not cont:
                flush(b, prev_vuid, carry)     # the carried run ended
            bounds = starts + [kc]
            for r in range(len(starts)):
                carried = r == 0 and cont
                ru = prev_vuid if carried else int(u[starts[r]])
                acc = carry.copy() if carried else np.zeros(27 * F, f32)
                for k in range(bounds[r], bounds[r + 1]):
                    if locc[k] < 0:
                        continue
                    a = pi - (locc[k] >> 2)
                    bb = pj - ((locc[k] >> 1) & 1)
                    e = pk - (locc[k] & 1)
                    hit = (a >= 0) & (a <= 1) & (bb >= 0) & (bb <= 1) \
                        & (e >= 0) & (e <= 1)
                    c = np.where(hit, (a << 2) | (bb << 1) | e, 0)
                    acc = np.where(hit, acc + ct[k, c, fq], acc).astype(f32)
                if r == len(starts) - 1 and not last_chunk:
                    carry = acc
                else:
                    flush(b, ru, acc)
            prev_vuid = last_uid
    return grad


def _plain(n_rows, W, urows, uid, lf, df, dj, F, jac_lo, jac_hi, bf16):
    T = torch.from_numpy
    return k1.fused_ray_reduce_bwd_plain(
        torch.zeros(n_rows, W), T(urows), T(uid), T(lf), T(df),
        None if dj is None else T(dj), F, jac_lo, jac_hi, bf16).numpy()


def _plan(rng, run_lens, Lg, T_, TS, Ug, n_table):
    """A `_unique_plan_uniform` plan over rows made of runs of the given
    lengths (cycled), each run a fresh table row; its uid, urows and
    overflow (cells past the cap)."""
    rows = np.empty((Lg, T_, TS), np.int32)
    for l in range(Lg):
        for t in range(T_):
            k, i = 0, int(rng.integers(len(run_lens)))
            while k < TS:
                n = run_lens[i % len(run_lens)]
                rows[l, t, k:k + n] = rng.integers(n_table)
                k, i = k + n, i + 1
    uid, urows, ovf = _unique_plan_uniform(
        torch.from_numpy(rows), torch.ones((T_, TS), dtype=torch.bool), Ug)
    return uid.numpy(), urows.numpy(), ovf.numpy()


def _inputs(rng, uid, ovf, F, Fj, with_dj, marks=True):
    """lf with integer local cells (the plan's overflow cells -9, as
    streambrick._grouped_reduce marks them, and, with marks, every 13th
    cell -9 inside its run), cotangents."""
    B, K = uid.shape
    Lg, T_, TS = ovf.shape
    loc = rng.integers(0, 2, (3, B, K)).astype(f32)
    ovf_b = ovf.transpose(1, 0, 2).reshape(B, K)
    loc[:, ovf_b] = -9.0
    if marks:
        loc[:, :, 5::13] = -9.0
    lf = np.concatenate([loc, rng.uniform(0, 1, (3, B, K)).astype(f32),
                         np.full((1, B, K), 37.5, f32),
                         np.zeros((1, B, K), f32)])
    df = rng.standard_normal((F, B, K)).astype(f32)
    dj = rng.standard_normal((3 * Fj, B, K)).astype(f32) if with_dj else None
    return lf, df, dj


def _distinct_rows(B, U):
    """Each slot its own table row, so that the order in which slots are
    added into the master cannot change a bit."""
    return np.arange(B * U, dtype=np.int32).reshape(B, U)


def _check_bitwise(urows, uid, lf, df, dj, F, jac_lo, jac_hi, bf16):
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    B, U = urows.shape
    W = 32 * F
    ref = _plain(B * U, W, urows, uid, lf, df, dj, F, jac_lo, jac_hi, bf16)
    out = model_k1_bwd(B * U, W, urows, uid, lf, df, dj, F, jac_lo, Fj, bf16)
    np.testing.assert_array_equal(out, ref)
    assert np.abs(ref).max() > 0
    return ref


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("F,window,with_dj", [(8, (0, None), True),
                                              (4, (1, 3), True),
                                              (8, (0, None), False)])
def test_model_matches_plain_on_stream_plans(bf16, F, window, with_dj):
    """Plans of the stream's dedup at a small cap: runs of 1 to 256
    cells, overflowed runs (-9, uid clipped to Ug - 1), -9 cells inside
    runs."""
    rng = np.random.default_rng(0)
    jac_lo, jac_hi = window
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    uid, _, ovf = _plan(rng, [1, 2, 3, 9, 40, 256, 7, 1, 120, 1, 2], 2, 3,
                        256, 8, 1000)
    assert ovf.any() and not ovf.all()
    lf, df, dj = _inputs(rng, uid, ovf, F, Fj, with_dj)
    _check_bitwise(_distinct_rows(uid.shape[0], 8), uid, lf, df, dj, F,
                   jac_lo, jac_hi, bf16)


@pytest.mark.parametrize("run_len", [1, 2, 9, 255, 256])
def test_model_matches_plain_for_each_run_length(run_len):
    """Every run of one length: each cell its own slot (1) up to one
    slot spanning the row (256), bf16."""
    rng = np.random.default_rng(run_len)
    uid, _, ovf = _plan(rng, [run_len], 1, 2, 256, 256, 10 ** 6)
    assert not ovf.any()
    lf, df, dj = _inputs(rng, uid, ovf, 8, 8, True)
    _check_bitwise(_distinct_rows(2, 256), uid, lf, df, dj, 8, 0, None,
                   True)


@pytest.mark.parametrize("bf16", [False, True])
def test_model_matches_plain_with_uid_outside_slots(bf16):
    """uids outside [0, U) inside runs and at the row's ends are skipped
    and break no run (the plain version sums the slot's cells around
    them into one row)."""
    rng = np.random.default_rng(3)
    uid, _, ovf = _plan(rng, [30, 5, 64], 1, 2, 256, 40, 1000)
    lf, df, dj = _inputs(rng, uid, ovf, 8, 8, True)
    uid = uid.copy()
    uid[0, 10:14] = 40               # inside the first run
    uid[1, ::17] = -1
    uid[1, -3:] = 99
    ref = _check_bitwise(_distinct_rows(2, 40), uid, lf, df, dj, 8, 0,
                         None, bf16)
    assert np.abs(ref[0]).max() > 0


@pytest.mark.parametrize("bf16", [False, True])
def test_model_matches_plain_across_chunks(bf16):
    """Rows longer than a chunk (K = 600): runs that cross the chunk
    ends at 256 and 512, one run longer than a chunk, a chunk whose
    every cell is -9 inside a run."""
    rng = np.random.default_rng(4)
    uid, _, ovf = _plan(rng, [37, 300, 3], 1, 2, 600, 80, 1000)
    lf, df, dj = _inputs(rng, uid, ovf, 8, 8, True)
    lf[0:3, 1, 256:512] = -9.0
    uid = uid.copy()
    uid[1, 200:560] = uid[1, 200]     # one slot over [200, 560)
    uid[1, 560:] = np.maximum(uid[1, 560:], uid[1, 200] + 1)
    _check_bitwise(_distinct_rows(2, 80), uid, lf, df, dj, 8, 0, None,
                   bf16)


def test_model_with_shared_rows_matches_plain():
    """The plan's own urows (slots of different tiles and levels may
    share a table row): flushed in slot order, as the plain version adds
    them, the model still gives its bits."""
    rng = np.random.default_rng(5)
    uid, urows, ovf = _plan(rng, [4, 11, 1, 60], 2, 2, 256, 48, 30)
    lf, df, dj = _inputs(rng, uid, ovf, 8, 8, True)
    ref = _plain(30, 256, urows, uid, lf, df, dj, 8, 0, None, True)
    out = model_k1_bwd(30, 256, urows, uid, lf, df, dj, 8, bf16=True)
    np.testing.assert_array_equal(out, ref)


def test_summing_a_slot_out_of_order_changes_bits():
    """Why k order is part of the contract: a slot summed in reverse
    order gives other f32 bits on some lanes (cotangents over eight
    decades, so that the sums are inexact); the bf16 variant rounds that
    sum, and where it lies near a bf16 rounding boundary the flip is 2^-8
    of the value, beyond the card check's 1e-5."""
    rng = np.random.default_rng(6)
    uid, _, ovf = _plan(rng, [256], 1, 1, 256, 4, 1000)
    lf, df, dj = _inputs(rng, uid, ovf, 8, 8, True, marks=False)
    df = (df * 10.0 ** rng.uniform(-4, 4, df.shape)).astype(f32)
    urows = _distinct_rows(1, 4)
    ref = _plain(4, 256, urows, uid, lf, df, dj, 8, 0, None, False)
    rev = _plain(4, 256, urows, uid[:, ::-1].copy(), lf[:, :, ::-1].copy(),
                 df[:, :, ::-1].copy(), dj[:, :, ::-1].copy(), 8, 0, None,
                 False)
    assert not np.array_equal(ref, rev)
    np.testing.assert_allclose(rev, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("seed", range(4))
def test_chunk_runs_find_one_run_per_slot(seed):
    """Step 2 against a direct computation: for a non-decreasing uid,
    over the chunks of a row, the runs are the slots of the valid cells,
    each starting at the slot's first valid cell."""
    rng = np.random.default_rng(seed)
    K, U = 700, 90
    uid = np.minimum(np.cumsum(rng.random(K) < 0.1), U + 5).astype(np.int32)
    valid = (uid < U) & (rng.random(K) > 0.3)
    starts, prev = [], -1
    for k0 in range(0, K, CHUNK):
        s, cont, prev = chunk_runs(uid[k0:k0 + CHUNK],
                                   valid[k0:k0 + CHUNK], prev)
        starts += [k0 + k for k in s[1 if cont else 0:]]
    slots, first = np.unique(uid[valid], return_index=True)
    np.testing.assert_array_equal(starts, np.flatnonzero(valid)[first])
    np.testing.assert_array_equal(uid[starts], slots)


# ------------------------------------------------------- K2 forward model

def k2_tile_samples(Lw):
    return 1 if Lw >= K2_THREADS else K2_THREADS // Lw


def k2_level_stride(Lw, S):
    if 32 % Lw:
        return S | 1
    g = (32 // Lw) % 32
    return S + ((g - S) % 32 + 32) % 32


def _store_slab(dst, dst_off, src, length):
    """k2_store_slab: (head, vector words, tail) index ranges of the
    store of src[:length] to dst[dst_off:], with dst's 16-byte words
    counted from element 0 (a tensor's data starts 16-byte aligned)."""
    head = min(length, (-dst_off) % 4)
    n4 = (length - head) // 4
    dst[dst_off:dst_off + head] = src[:head]
    words = src[head:head + 4 * n4].reshape(-1, 4)
    assert (dst_off + head) % 4 == 0
    dst[dst_off + head:dst_off + head + 4 * n4] = words.reshape(-1)
    dst[dst_off + head + 4 * n4:dst_off + length] = \
        src[head + 4 * n4:length]


def model_k2_layout(cell_feats, cell_jac, Lw, N, F, Fj):
    """The redesigned K2's data movement for per-cell results
    cell_feats (Lw, N, F) and cell_jac (3, Lw, N, Fj) or None: tiles of
    S samples, the level-major input index of each cell, the
    level-fastest staging at t*F (t = n*Lw + l), the slab stores.
    Returns the flat feats (N*Lw*F) and jac (3*N*Lw*Fj) buffers."""
    S = k2_tile_samples(Lw)
    P = k2_level_stride(Lw, S)
    feats = np.full(N * Lw * F, np.nan, f32)
    jac = None if cell_jac is None else np.full(3 * N * Lw * Fj, np.nan, f32)
    for n0 in range(0, N, S):
        s_eff = min(S, N - n0)
        staged = {}
        for t in range(S * Lw):                       # step 1
            l, n = divmod(t, S)
            if n < s_eff:
                staged[l * P + n] = (l, n0 + n)
        s_feat = np.zeros(S * Lw * F, f32)
        s_jac = np.zeros((3, S * Lw * Fj), f32)
        for t in range(s_eff * Lw):                   # step 2
            n, l = divmod(t, Lw)
            ll, nn = staged[l * P + n]
            assert (ll, nn) == (l, n0 + n)
            s_feat[t * F:(t + 1) * F] = cell_feats[l, nn]
            if jac is not None:
                s_jac[:, t * Fj:(t + 1) * Fj] = cell_jac[:, l, nn]
        _store_slab(feats, n0 * Lw * F, s_feat, s_eff * Lw * F)   # step 3
        if jac is not None:
            for i in range(3):
                _store_slab(jac, i * N * Lw * Fj + n0 * Lw * Fj, s_jac[i],
                            s_eff * Lw * Fj)
    return feats, jac


@pytest.mark.parametrize("Lw,N,F,window", [(4, 3000 + 37, 8, (0, None)),
                                           (16, 1000, 8, None),
                                           (3, 1001, 4, (1, 3)),
                                           (5, 77, 2, (1, 2)),
                                           (1, 300, 8, (0, None))])
def test_k2_model_lands_every_value(Lw, N, F, window):
    """The tile scheme puts each cell's values where brick_reduce_plain
    does: ragged last tiles (N % S != 0), Lw that does not divide 256,
    jacobian planes of a length that is no multiple of 4 (an unaligned
    head on planes 1 and 2)."""
    rng = np.random.default_rng(Lw)
    W, R = 32 * F, 50
    table = torch.from_numpy(rng.standard_normal((R, W)).astype(f32))
    rows = torch.from_numpy(rng.integers(0, R, (Lw, N)).astype(np.int32))
    loc = rng.integers(0, 2, (3, Lw, N)).astype(f32)
    loc[:, :, ::9] = -9.0
    lf = torch.from_numpy(np.concatenate(
        [loc, rng.uniform(0, 1, (3, Lw, N)), np.full((1, Lw, N), 8.0),
         np.zeros((1, Lw, N))]).astype(f32))
    with_jac = window is not None
    jac_lo, jac_hi = window if with_jac else (0, None)
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    ref_f, ref_j = k2.brick_reduce_plain(table, rows, lf, F, with_jac,
                                         jac_lo, jac_hi)
    ref_f, ref_j = ref_f.numpy(), None if ref_j is None else ref_j.numpy()
    cell_f = ref_f.reshape(N, Lw, F).transpose(1, 0, 2)
    cell_j = None if ref_j is None else \
        ref_j.reshape(3, N, Lw, Fj).transpose(0, 2, 1, 3)
    feats, jac = model_k2_layout(cell_f, cell_j, Lw, N, F, Fj)
    np.testing.assert_array_equal(feats, ref_f.reshape(-1))
    if with_jac:
        np.testing.assert_array_equal(jac, ref_j.reshape(-1))
        if (N * Lw * Fj) % 4:
            assert any((i * N * Lw * Fj) % 4 for i in (1, 2))


@pytest.mark.parametrize("Lw", [1, 2, 3, 4, 5, 8, 12, 16, 32, 64])
def test_k2_tile_and_level_stride(Lw):
    """S*Lw fills the 256 threads; the level stride P holds S samples;
    when Lw divides 32, the 32 cells of each warp of step 2 (t = n*Lw +
    l) read 32 distinct banks at l*P + n."""
    S = k2_tile_samples(Lw)
    P = k2_level_stride(Lw, S)
    assert S * Lw <= K2_THREADS and (S + 1) * Lw > K2_THREADS
    assert P >= S
    if 32 % Lw == 0:
        for w in range(S * Lw // 32):
            t = np.arange(32 * w, 32 * w + 32)
            n, l = t // Lw, t % Lw
            assert len(set((l * P + n) % 32)) == 32
