"""The order of operations of the redesigned K3 backward and K2 backward,
as numpy models of the CUDA kernels (ingp_tpu_torch/kernels/csrc/
composite.cu composite_bwd_kernel, brickreduce.cu
brick_reduce_bwd_kernel), on the CPU.

K3 backward: a warp takes a ray, its 32 lanes the ray's samples in
segments of 32. Pass 1 loads each input once; one lane sums the
segment's sd = valid ? sigma*dt : 0 in K3 forward's serial
front-to-back order, carrying the sum from segment to segment, so the
include rule T > thr sees the forward's bits; the lanes keep w, T', dt,
t, rgb and dws_eff = dws + sum_c dAux_c aux_c and their partial totals,
which butterfly (xor) reductions finish. Pass 2 takes the prefix sums
of w t, w rgb and dws_eff w by inclusive warp scans carried across
segments. The model's csum must equal the serial forward's bit for
bit; its outputs must be within 1e-6 of the largest value of
`composite_bwd_plain`, which sums in other orders.

K2 backward: a block owns a tile of S samples x Lw levels; it copies the
tile's df rows and dj plane rows (at the caller's row stride) into
shared memory at a padded row stride; a thread per cell, level-major,
reads its row id and lf at c = l*N + n, its cotangents from the staged
rows (a cell whose cotangents are all 0 stops there), computes its 8
corners' lane values (rounded to bf16 per cell in the bf16 variant) and
adds each corner whose lanes are not all 0 into the master row. Runs of cells on one row are not summed first (on
training's inputs they hold ~1.3 cells). The model must land every
value where `brick_reduce_bwd_plain` puts it: bit for bit where no two
cells share a row, else within 1e-6 of the largest value (only the
order of the f32 adds differs).
"""
import numpy as np
import pytest
import torch

from ingp_tpu_torch.kernels import brickreduce as k2
from ingp_tpu_torch.kernels import composite as k3
from tests.test_torch_kernel_redesign import (_bf16, cell_cotangents,
                                              k2_tile_samples)
from tests._torch_threads import one_torch_thread  # noqa: F401

f32 = np.float32
LANES = 32           # composite.cu: a warp per ray, a lane per sample


# ------------------------------------------------------- K3 backward model

def _exp(x):
    """The elementwise exp of the plain version (torch on f32)."""
    return torch.exp(torch.from_numpy(np.asarray(x, f32))).numpy()


def _xor_total(v):
    """k3_total: a butterfly over the lanes (R, 32)."""
    lane = np.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[:, lane ^ o]).astype(f32)
    return v[:, 0]


def _warp_scan(v):
    """k3_scan: a Hillis-Steele inclusive scan over the lanes (R, 32)."""
    lane = np.arange(LANES)
    for d in (1, 2, 4, 8, 16):
        up = np.concatenate([np.zeros((v.shape[0], d), f32), v[:, :-d]], 1)
        v = np.where(lane >= d, v + up, v).astype(f32)
    return v


def serial_csum(sd):
    """K3 forward's csum: one thread per ray, front to back, in f32."""
    return np.cumsum(sd, axis=1, dtype=f32)


def model_k3_bwd(sig, dt, ts, valid, thr, rgbs, aux, dws, dO, dD, dC, dAux):
    """composite_bwd_kernel over all rays at once: returns (dsig, drgb,
    daux, csum)."""
    R, S = sig.shape
    C = aux.shape[0]
    sd = np.where(valid, (sig * dt).astype(f32), f32(0))
    de = dws.copy()
    for c in range(C):
        de = (de + dAux[:, c, None] * aux[c]).astype(f32)
    cs = np.empty((R, S), f32)
    csum = np.zeros(R, f32)
    for s0 in range(0, S, LANES):             # lane 0's serial sum
        for j in range(min(LANES, S - s0)):
            csum = (csum + sd[:, s0 + j]).astype(f32)
            cs[:, s0 + j] = csum
    T = _exp(-(cs - sd))
    inc = valid & (T > f32(thr))
    alpha = (f32(1) - _exp(-sd)).astype(f32)
    w = np.where(inc, (alpha * T).astype(f32), f32(0))
    Ta = (T * (f32(1) - alpha)).astype(f32)
    dtv = np.where(inc, dt, f32(-1))
    terms = {"O": w, "D": w * ts, "C0": w * rgbs[0], "C1": w * rgbs[1],
             "C2": w * rgbs[2], "W": de * w}
    tot = {}
    for k, v in terms.items():
        part = np.zeros((R, LANES), f32)
        for s0 in range(0, S, LANES):
            n = min(LANES, S - s0)
            part[:, :n] = (part[:, :n] + v[:, s0:s0 + n]).astype(f32)
        tot[k] = _xor_total(part)[:, None]
    dsig = np.zeros((R, S), f32)
    pref = {k: np.zeros((R, S), f32) for k in ("D", "C0", "C1", "C2", "W")}
    carry = {k: np.zeros(R, f32) for k in pref}
    for s0 in range(0, S, LANES):
        n = min(LANES, S - s0)
        for k in pref:
            seg = np.zeros((R, LANES), f32)
            seg[:, :n] = terms[k][:, s0:s0 + n]
            p = (carry[k][:, None] + _warp_scan(seg)).astype(f32)
            pref[k][:, s0:s0 + n] = p[:, :n]
            carry[k] = p[:, LANES - 1]
    acc = (dO[:, None] * (f32(1) - tot["O"])
           + dD[:, None] * (ts * Ta - (tot["D"] - pref["D"])))
    acc = acc + Ta * de - (tot["W"] - pref["W"])
    for c in range(3):
        acc = acc + dC[:, c, None] * (rgbs[c] * Ta
                                      - (tot[f"C{c}"] - pref[f"C{c}"]))
    dsig = np.where(dtv >= 0, (dtv * acc).astype(f32), f32(0))
    drgb = (dC.T[:, :, None] * w[None]).astype(f32)
    daux = (dAux.T[:, :, None] * w[None]).astype(f32)
    return dsig, drgb, daux, cs


def _k3_inputs(rng, R, S, C, dyadic=False):
    """Rays valid on a random subset (ray 0 all invalid, ray 1 all
    valid, ray 2 valid on a prefix), densities over four decades; with
    dyadic, sigma*dt and every partial sum exact in f32."""
    valid = rng.random((R, S)) < 0.7
    valid[0] = False
    valid[1] = True
    valid[2] = np.arange(S) < S // 3
    if dyadic:
        sig = rng.integers(0, 64, (R, S)).astype(f32)
        dt = np.full((R, S), 1 / 64, f32)
    else:
        sig = (10.0 ** rng.uniform(-2, 3, (R, S))).astype(f32)
        dt = rng.uniform(0.002, 0.03, (R, S)).astype(f32)
    ts = (np.cumsum(dt, 1) + 0.3).astype(f32)
    g = lambda *s: rng.standard_normal(s).astype(f32)   # noqa: E731
    return dict(sigmas=sig, deltas=dt, ts=ts, valid=valid,
                rgbs=rng.uniform(0, 1, (3, R, S)).astype(f32),
                aux=g(C, R, S), dws=g(R, S), dO=g(R), dD=g(R), dC=g(R, 3),
                dAux=g(R, C))


def _plain_k3(inp, thr):
    T = torch.from_numpy
    a = {k: T(v) for k, v in inp.items()}
    return [t.numpy() for t in k3.composite_bwd_plain(
        a["sigmas"], a["deltas"], a["ts"], a["valid"], thr, a["rgbs"],
        a["aux"], a["dws"], a["dO"], a["dD"], a["dC"], a["dAux"])]


def _model_k3(inp, thr):
    return model_k3_bwd(inp["sigmas"], inp["deltas"], inp["ts"],
                        inp["valid"], thr, inp["rgbs"], inp["aux"],
                        inp["dws"], inp["dO"], inp["dD"], inp["dC"],
                        inp["dAux"])


def _check_k3(inp, thr):
    """The model against the serial forward (csum bit for bit, so the
    include mask) and against composite_bwd_plain (1e-6 of the largest
    value); dsigma exactly 0 off the include mask."""
    *out, cs = _model_k3(inp, thr)
    sd = np.where(inp["valid"], (inp["sigmas"] * inp["deltas"]).astype(f32),
                  f32(0))
    np.testing.assert_array_equal(cs, serial_csum(sd))
    fwd = k3.composite_plain(*(torch.from_numpy(inp[k]) for k in (
        "sigmas", "deltas", "ts", "valid")), thr, with_Ts=True)
    inc = inp["valid"] & (fwd["Ts"].numpy() > f32(thr))
    assert not out[0][~inc].any()
    for a, b in zip(out, _plain_k3(inp, thr)):
        assert a.shape == b.shape
        if not b.size:                       # daux with no aux channel
            continue
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-6 * scale, (np.abs(a - b).max(),
                                                     scale)
    return inc


@pytest.mark.parametrize("C", [0, 13])
@pytest.mark.parametrize("S", [24, 48, 64, 100])
def test_k3_model_matches_plain(S, C):
    """Segments of 32 (one partial: 24, 48, 100; whole: 64), training's
    threshold 1e-4, an all-invalid ray, a ray valid everywhere, a ray
    valid on a prefix."""
    rng = np.random.default_rng(S + C)
    inp = _k3_inputs(rng, 40, S, C)
    inc = _check_k3(inp, 1e-4)
    assert inc[1:].any() and not inc[0].any()
    assert (~inc & inp["valid"]).any()       # some cut by the threshold


@pytest.mark.parametrize("S", [48, 100])
def test_k3_model_sample_at_the_threshold(S):
    """A threshold equal to one sample's transmittance: that sample is
    excluded (T > thr fails) and its predecessor, whose T is larger, is
    included. Dyadic sigma*dt keep every csum exact, so the plain
    version's T has the same bits."""
    rng = np.random.default_rng(7)
    inp = _k3_inputs(rng, 16, S, 13, dyadic=True)
    sd = np.where(inp["valid"], inp["sigmas"] * inp["deltas"], 0)
    cs = serial_csum(sd.astype(f32))
    T = _exp(-(cs - sd.astype(f32)))
    r, j = 1, S // 2
    assert T[r, j - 1] > T[r, j] > 0
    thr = float(T[r, j])
    inc = _check_k3(inp, thr)
    assert inc[r, j - 1] and not inc[r, j]


def test_k3_model_csum_carries_across_segments():
    """Rays longer than one segment carry lane 0's sum: with the carry
    dropped, the second segment's csum (and so T) would restart at 0."""
    rng = np.random.default_rng(9)
    inp = _k3_inputs(rng, 8, 100, 0)
    *_, cs = _model_k3(inp, 1e-4)
    sd = np.where(inp["valid"], (inp["sigmas"] * inp["deltas"]).astype(f32),
                  f32(0))
    restart = np.concatenate([serial_csum(sd[:, s0:s0 + 32])
                              for s0 in range(0, 100, 32)], 1)
    assert not np.array_equal(cs[1], restart[1])
    np.testing.assert_array_equal(cs, serial_csum(sd))


# ------------------------------------------------------- K2 backward model

def k2b_row_stride(length):
    """brickreduce.cu k2b_row_stride: whole 16-byte words, an odd
    number of them."""
    q = (length + 3) & ~3
    return q if (q >> 2) & 1 else q + 4


def model_k2_bwd(n_rows, W, rows, lf, df, dj, F, jac_lo, Fj, bf16):
    """brick_reduce_bwd_kernel, tile after tile. df (N, Lw*F) and dj
    (3, N, Lw*Fj) may be strided views; the staged rows are read back
    at the padded stride (NaN where nothing was staged)."""
    Lw, N = rows.shape
    S = k2_tile_samples(Lw)
    Qf, Qj = k2b_row_stride(Lw * F), k2b_row_stride(Lw * Fj)
    grad = np.zeros((n_rows, W), f32)
    for n0 in range(0, N, S):
        s_eff = min(S, N - n0)
        s_df = np.full(S * Qf, np.nan, f32)               # step 1
        s_dj = np.full((3, S * Qj), np.nan, f32)
        for row in range(s_eff):
            s_df[row * Qf:row * Qf + Lw * F] = df[n0 + row]
            if dj is not None:
                for p in range(3):
                    s_dj[p, row * Qj:row * Qj + Lw * Fj] = dj[p, n0 + row]
        for t in range(S * Lw):                           # step 2
            l, n = divmod(t, S)
            if n >= s_eff:
                continue
            loc, r = lf[0:3, l, n0 + n], rows[l, n0 + n]
            if not (((loc >= 0) & (loc <= 1)).all() and 0 <= r < n_rows):
                continue
            dfv = s_df[n * Qf + l * F:n * Qf + l * F + F]
            djv = None if dj is None else np.concatenate(
                [s_dj[p, n * Qj + l * Fj:n * Qj + l * Fj + Fj]
                 for p in range(3)])
            if not (dfv.any() or (djv is not None and djv.any())):
                continue                      # all-zero cotangents
            ct = cell_cotangents(lf[:, l, n0 + n], dfv, djv, F, jac_lo, Fj,
                                 bf16)
            ix, iy, iz = (int(v) for v in loc)
            for c in range(8):
                if not ct[c].any():
                    continue
                a, b, e = c >> 2, (c >> 1) & 1, c & 1
                pt = 9 * (ix + a) + 3 * (iy + b) + (iz + e)
                grad[r, pt * F:pt * F + F] += ct[c]
    return grad


def _k2b_inputs(rng, Lw, N, F, Fj, n_rows, run_len, with_dj, pad=0):
    """Rows made of runs of `run_len` consecutive samples per level
    (runs cross tile ends), -9 cells inside runs, rows outside the
    table, and a zero-cotangent tail of `pad` samples on one row (the
    stream's zero padding); df and dj as column slices of wider
    tensors (the row strides of torch.cat's backward)."""
    runs = rng.integers(0, n_rows, (Lw, -(-N // run_len)))
    rows = np.repeat(runs, run_len, 1)[:, :N].astype(np.int32)
    rows[:, 5::37] = n_rows + 2
    loc = rng.integers(0, 2, (3, Lw, N)).astype(f32)
    loc[:, :, 3::11] = -9.0
    lf = np.concatenate([loc, rng.uniform(0, 1, (3, Lw, N)),
                         np.full((1, Lw, N), 37.5), np.zeros((1, Lw, N))]
                        ).astype(f32)
    wide = rng.standard_normal((N, (Lw + 3) * F)).astype(f32)
    df = wide[:, 2 * F:2 * F + Lw * F]
    dj = None
    if with_dj:
        dj = rng.standard_normal((3, N, (Lw + 1) * Fj)).astype(f32)[
            :, :, Fj:]
    if pad:
        rows[:, -pad:] = 0
        lf[0:3, :, -pad:] = 0.0
        df[-pad:] = 0.0
        if with_dj:
            dj[:, -pad:] = 0.0
    return rows, lf, df, dj


def _k2b_check(rows, lf, df, dj, F, window, bf16, n_rows, bitwise):
    jac_lo, jac_hi = window
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    W = 32 * F
    T = torch.from_numpy
    ref = k2.brick_reduce_bwd_plain(
        torch.zeros(n_rows, W), T(rows), T(lf), T(np.ascontiguousarray(df)),
        None if dj is None else T(np.ascontiguousarray(dj)), F, jac_lo,
        jac_hi, bf16).numpy()
    out = model_k2_bwd(n_rows, W, rows, lf, df, dj, F, jac_lo, Fj, bf16)
    assert np.abs(ref).max() > 0
    if bitwise:
        np.testing.assert_array_equal(out, ref)
    else:
        assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("Lw,N,F,window,with_dj", [
    (4, 200, 8, (0, None), True),        # training's density: 3 tiles + 8
    (4, 200, 8, (0, None), False),       # training's rgb
    (16, 40, 8, (0, None), True),        # Lw 16: tiles of 16 samples
    (3, 90, 4, (1, 3), True),            # S*Lw < 256, a jacobian window
    (5, 60, 2, (1, 2), True)])
def test_k2_bwd_model_lands_every_value(bf16, Lw, N, F, window, with_dj):
    """Each cell on its own row: the model gives the plain version's
    bits, bf16 rounding per cell included."""
    rng = np.random.default_rng(Lw * 100 + N)
    Fj = (F if window[1] is None else window[1]) - window[0]
    rows, lf, df, dj = _k2b_inputs(rng, Lw, N, F, Fj, 10 ** 6, 1, with_dj)
    rows = np.arange(Lw * N, dtype=np.int32).reshape(Lw, N)
    rows[:, 5::37] = Lw * N + 2                       # outside the table
    _k2b_check(rows, lf, df, dj, F, window, bf16, Lw * N, True)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("Lw,N,run_len", [(4, 200, 3), (4, 200, 70),
                                          (16, 40, 5), (16, 40, 40)])
def test_k2_bwd_model_with_shared_rows(bf16, Lw, N, run_len):
    """Runs of consecutive samples on one row (70 and 40 cross tile
    ends), -9 cells inside runs, rows shared across levels and tiles, a
    zero-cotangent tail on one row: within 1e-6 of the largest value."""
    rng = np.random.default_rng(run_len)
    rows, lf, df, dj = _k2b_inputs(rng, Lw, N, 8, 8, 50, run_len, True,
                                   pad=17)
    _k2b_check(rows, lf, df, dj, 8, (0, None), bf16, 50, False)


def test_k2_bwd_bf16_rounds_each_cell_before_the_sum():
    """Why the bf16 variant rounds per cell: on a row shared by many
    cells, rounding the sum instead gives other values (the check
    above would see them)."""
    rng = np.random.default_rng(3)
    rows, lf, df, dj = _k2b_inputs(rng, 4, 64, 8, 8, 1, 64, True)
    out = model_k2_bwd(1, 256, rows, lf, df, dj, 8, 0, 8, True)
    summed = model_k2_bwd(1, 256, rows, lf, df, dj, 8, 0, 8, False)
    assert np.abs(_bf16(summed) - out).max() > 1e-3 * np.abs(out).max()


@pytest.mark.parametrize("length", [2, 6, 8, 12, 32, 128])
def test_k2_bwd_row_stride(length):
    """The staged row stride holds the row, keeps 16-byte words aligned,
    and puts the words of 8 consecutive rows in 8 distinct bank groups
    (the float4 reads of 8 consecutive samples at one level)."""
    Q = k2b_row_stride(length)
    assert Q >= length and Q % 4 == 0
    assert len({(n * Q // 4) % 8 for n in range(8)}) == 8


# ------------------------------------------------ the launchers' signatures

def test_every_launcher_has_its_ctypes_signature():
    """Each `extern "C"` launcher of kernels/csrc has an entry in the
    signature table of its library (build.SIGNATURES: the kernels'
    sources, and the probes' csrc/probe_*.cu) with one ctypes type per
    parameter, 64-bit where the C parameter is int64_t and c_float where
    it is float: ctypes passes an undeclared int as 32 bits and a Python
    float as a double, which cuts a 64-bit count or garbles a float
    argument. The two libraries share no source and no launcher."""
    import ctypes
    import re
    from ingp_tpu_torch.kernels import build
    kind = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
            "float": ctypes.c_float}
    assert set(build.SIGNATURES) == {"kernels", "probes"}
    assert not set(build.sources("kernels")) & set(build.sources("probes"))
    assert (set(build.sources("kernels")) | set(build.sources("probes"))
            == set(build.CSRC.glob("*.cu")))
    for lib, table in build.SIGNATURES.items():
        found = {}
        for src in build.sources(lib):
            text = src.read_text()
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
                params = [" ".join(p.split()) for p in m.group(2).split(",")]
                found[m.group(1)] = [
                    ctypes.c_void_p if "*" in p
                    else kind[p.rsplit(" ", 1)[0]] for p in params]
        assert set(found) == set(table), lib
        for name, types in found.items():
            assert table[name] == types, name


# ------------------------------------------------ the two libraries' builds

def test_library_hash_covers_only_its_own_headers(tmp_path, monkeypatch):
    """A library's hash reads its sources and the headers they include,
    directly or through another header, and no other: an edit to a
    header only the probes include leaves the kernels' library (the one
    training loads) as it was."""
    from ingp_tpu_torch.kernels import build
    assert [p.name for p in build.headers("kernels")] == ["k3.cuh",
                                                          "trilerp.cuh"]
    assert "async_copy.cuh" in {p.name for p in build.headers("probes")}
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "x.cuh"\n')
    (csrc / "x.cuh").write_text('#include "y.cuh"\n')
    (csrc / "y.cuh").write_text("// y\n")
    (csrc / "probe_b.cu").write_text('#include "z.cuh"\n')
    (csrc / "z.cuh").write_text("// z\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    assert [p.name for p in build.headers("kernels")] == ["x.cuh", "y.cuh"]
    kernels, probes = build.source_hash("kernels"), build.source_hash("probes")
    (csrc / "z.cuh").write_text("// z, edited\n")
    assert build.source_hash("kernels") == kernels
    assert build.source_hash("probes") != probes
    (csrc / "y.cuh").write_text("// y, edited\n")
    assert build.source_hash("kernels") != kernels


def test_build_writes_its_files_only_once_it_succeeded(tmp_path, monkeypatch):
    """`build_libraries` with a stand-in compiler: each call reports into
    a file of this process's own; a build that succeeded replaces the
    library and its report, one that failed raises with its report and
    leaves neither a library nor a stray file behind."""
    import sys
    from ingp_tpu_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    script = ("import sys, pathlib; lib, out = sys.argv[1:]; "
              "sys.stderr.write(f'report of {lib}'); "
              "sys.exit(3) if lib == 'probes' else "
              "pathlib.Path(out).write_bytes(b'so')")
    monkeypatch.setattr(build, "_nvcc_cmd", lambda lib, out: [
        sys.executable, "-c", script, lib, str(out)])
    assert build.build_libraries(("kernels",)) == {
        "kernels": "report of kernels"}
    lib = build.library_path("kernels")
    assert lib.read_bytes() == b"so"
    assert lib.with_suffix(".log").read_text() == "report of kernels"
    with pytest.raises(RuntimeError, match="probes: nvcc failed "
                                           r"\(exit 3\):\nreport of probes"):
        build.build_libraries(("kernels", "probes"))
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])
