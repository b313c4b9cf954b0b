"""The order of operations of the redesigned K3 forward, as a numpy model
of the CUDA kernel (ingp_tpu_torch/kernels/csrc/composite.cu
composite_fwd_kernel), on the CPU.

A group of G lanes takes a ray, its lanes the ray's samples in segments
of G (G = 16 in the kernel). Per segment each lane loads its sample's
inputs once; lane 0 sums the segment's sd = valid ? sigma*dt : 0 front to
back, carrying the sum from segment to segment (k3_csum_walk, which K3
backward runs too); each lane makes T = exp(-(csum - sd)) and w, writes
ws and Ts, and adds into its partials of opacity, depth, rgb, count and
the aux channels; one butterfly per quantity gives the totals.

The model must give the bits of the thread-per-ray body it replaced (one
thread walking the ray serially, the aux sums re-reading ws) on ws, Ts
and count, and the csum of the K3 backward model in
tests/test_torch_bwd_redesign.py; opacity, depth, rgb and aux, which
change only in summation order, must agree with `composite_plain` to
rtol 1e-6 (with an absolute floor of 1e-6 of the largest value, for the
aux channels' signed sums that cancel).
"""
import numpy as np
import pytest
import torch

from ingp_tpu_torch.kernels import composite as k3
from ingp_tpu_torch.ops import composite as ops
from tests.test_torch_bwd_redesign import _exp, model_k3_bwd, serial_csum
from tests._torch_threads import one_torch_thread  # noqa: F401

f32 = np.float32
GROUP = 16           # composite.cu kK3FwdGroup: lanes per ray


def _fma(a, b, c):
    """fmaf in f32: the product and sum in f64, one rounding to f32 (the
    f64 product of two f32 values is exact)."""
    return (np.asarray(a, np.float64) * b + c).astype(f32)


def _weights(sd, cs, valid, thr):
    T = _exp(-(cs - sd))
    w = np.where(valid & (T > f32(thr)),
                 ((f32(1) - _exp(-sd)).astype(f32) * T).astype(f32), f32(0))
    return w, T


def _group_total(v, G):
    """k3_total<G>: a butterfly over the G lanes (R, G)."""
    lane = np.arange(G)
    o = G // 2
    while o:
        v = (v + v[:, lane ^ o]).astype(v.dtype)
        o //= 2
    return v[:, 0]


def model_k3_fwd(sig, dt, ts, valid, thr, rgbs=None, aux=None, G=GROUP):
    """composite_fwd_kernel over all rays at once, groups of G lanes:
    the outputs of `composite_fwd` and the csum."""
    R, S = sig.shape
    sd = np.where(valid, (sig * dt).astype(f32), f32(0))
    cs = np.empty((R, S), f32)
    csum = np.zeros(R, f32)
    for s0 in range(0, S, G):                 # lane 0's serial walk
        for j in range(min(G, S - s0)):
            csum = (csum + sd[:, s0 + j]).astype(f32)
            cs[:, s0 + j] = csum
    w, T = _weights(sd, cs, valid, thr)
    planes = {"opacity": None}
    if ts is not None:
        planes["depth"] = ts
    if rgbs is not None:
        planes.update({f"rgb{c}": rgbs[c] for c in range(3)})
    if aux is not None:
        planes.update({f"aux{c}": aux[c] for c in range(aux.shape[0])})
    part = {k: np.zeros((R, G), f32) for k in planes}
    n = np.zeros((R, G), np.int64)
    for s0 in range(0, S, G):                 # the lanes' partials
        m = min(G, S - s0)
        ws = w[:, s0:s0 + m]
        for k, p in planes.items():
            part[k][:, :m] = (part[k][:, :m] + ws if p is None else
                              _fma(ws, p[:, s0:s0 + m], part[k][:, :m]))
        n[:, :m] += ws > 0
    tot = {k: _group_total(v, G) for k, v in part.items()}
    out = {"ws": w, "Ts": T, "opacity": tot["opacity"],
           "count": _group_total(n, G).astype(np.int32)}
    if ts is not None:
        out["depth"] = tot["depth"]
    if rgbs is not None:
        out["rgb"] = np.stack([tot[f"rgb{c}"] for c in range(3)], 1)
    if aux is not None:
        out["aux"] = np.stack([tot[f"aux{c}"] for c in range(aux.shape[0])],
                              1).reshape(R, aux.shape[0])
    return out, cs


def model_k3_fwd_thread(sig, dt, ts, valid, thr, rgbs=None, aux=None):
    """The thread-per-ray body the kernel replaced (the K1/K2/K3 split's
    `k3 fwd full`): one serial walk per ray, then the aux sums over the
    stored ws."""
    R, S = sig.shape
    sd = np.where(valid, (sig * dt).astype(f32), f32(0))
    w, T = _weights(sd, serial_csum(sd), valid, thr)
    op, dp = np.zeros(R, f32), np.zeros(R, f32)
    rgb = np.zeros((R, 3), f32)
    n = np.zeros(R, np.int32)
    for s in range(S):
        op = (op + w[:, s]).astype(f32)
        if ts is not None:
            dp = _fma(w[:, s], ts[:, s], dp)
        n += w[:, s] > 0
        if rgbs is not None:
            for c in range(3):
                rgb[:, c] = _fma(w[:, s], rgbs[c, :, s], rgb[:, c])
    out = {"ws": w, "Ts": T, "opacity": op, "count": n}
    if ts is not None:
        out["depth"] = dp
    if rgbs is not None:
        out["rgb"] = rgb
    if aux is not None:
        acc = np.zeros((R, aux.shape[0]), f32)
        for c in range(aux.shape[0]):
            for s in range(S):
                acc[:, c] = _fma(w[:, s], aux[c, :, s], acc[:, c])
        out["aux"] = acc
    return out


def _inputs(rng, R, S, C, dyadic=False):
    """Rays valid on a random subset (ray 0 all invalid, ray 1 all valid,
    ray 2 valid on a prefix), densities over four decades; with dyadic,
    sigma*dt and every partial sum exact in f32."""
    valid = rng.random((R, S)) < 0.7
    valid[0] = False
    valid[1] = True
    valid[2] = np.arange(S) < max(S // 3, 1)
    if dyadic:
        sig = rng.integers(0, 64, (R, S)).astype(f32)
        dt = np.full((R, S), 1 / 64, f32)
    else:
        sig = (10.0 ** rng.uniform(-2, 3, (R, S))).astype(f32)
        dt = rng.uniform(0.002, 0.03, (R, S)).astype(f32)
    ts = (np.cumsum(dt, 1) + 0.3).astype(f32)
    return dict(sigmas=sig, deltas=dt, ts=ts, valid=valid,
                rgbs=rng.uniform(0, 1, (3, R, S)).astype(f32),
                aux=rng.standard_normal((C, R, S)).astype(f32))


def _args(inp, rgb, with_ts, C):
    return dict(sig=inp["sigmas"], dt=inp["deltas"],
                ts=inp["ts"] if with_ts else None, valid=inp["valid"],
                rgbs=inp["rgbs"] if rgb else None,
                aux=inp["aux"] if C else None)


def _plain(a, thr):
    T = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    out = k3.composite_plain(T(a["sig"]), T(a["dt"]), T(a["ts"]),
                             T(a["valid"]), thr, T(a["rgbs"]), T(a["aux"]),
                             with_Ts=True)
    return {k: v.numpy() for k, v in out.items()}


def _check(a, thr, G=GROUP):
    """The model against the thread-per-ray body (ws, Ts and count
    bitwise), the K3 backward model's csum (bitwise) and composite_plain
    (rtol 1e-6, absolute floor 1e-6 of the largest value)."""
    out, cs = model_k3_fwd(a["sig"], a["dt"], a["ts"], a["valid"], thr,
                           a["rgbs"], a["aux"], G)
    old = model_k3_fwd_thread(a["sig"], a["dt"], a["ts"], a["valid"], thr,
                              a["rgbs"], a["aux"])
    assert set(out) == set(old)
    for k in ("ws", "Ts", "count"):
        np.testing.assert_array_equal(out[k], old[k], err_msg=k)
    R, S = a["sig"].shape
    C = 0 if a["aux"] is None else a["aux"].shape[0]
    z = lambda *s: np.zeros(s, f32)                      # noqa: E731
    *_, cs_bwd = model_k3_bwd(a["sig"], a["dt"], z(R, S), a["valid"], thr,
                              z(3, R, S), z(C, R, S), z(R, S), z(R), z(R),
                              z(R, 3), z(R, C))
    np.testing.assert_array_equal(cs, cs_bwd)
    ref = _plain(a, thr)
    assert set(ref) == set(out)
    np.testing.assert_array_equal(out["count"], ref["count"])
    for k in set(out) - {"ws", "Ts", "count"}:
        scale = float(np.abs(ref[k]).max()) if ref[k].size else 0.0
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-6,
                                   atol=1e-6 * scale, err_msg=k)
    return out


@pytest.mark.parametrize("rgb,with_ts", [(True, True), (True, False),
                                         (False, True), (False, False)])
@pytest.mark.parametrize("C", [0, 3, 13])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 48, 100])
def test_k3_fwd_model_matches_old_body_and_plain(S, C, rgb, with_ts):
    """Segments of 16 (one partial: 1, 31, 33, 100; whole: 32, 48),
    training's threshold 1e-4, with and without rgb and ts, an
    all-invalid ray (all outputs exactly 0), a ray valid everywhere, a
    ray valid on a prefix."""
    rng = np.random.default_rng(100 * S + 10 * C + 2 * rgb + with_ts)
    a = _args(_inputs(rng, 40, S, C), rgb, with_ts, C)
    out = _check(a, 1e-4)
    for k, v in out.items():
        if k != "Ts":
            assert not v[0].any(), k
    assert out["count"][1:].any()


@pytest.mark.parametrize("G", [8, 32])
@pytest.mark.parametrize("S", [33, 48, 100])
def test_k3_fwd_model_bits_do_not_depend_on_the_group(S, G):
    """ws, Ts and count keep the serial body's bits at any group width:
    only the sums' order moves with it."""
    rng = np.random.default_rng(S + G)
    _check(_args(_inputs(rng, 24, S, 13), True, True, 13), 1e-4, G)


@pytest.mark.parametrize("S", [17, 48, 100])
def test_k3_fwd_model_sample_at_the_threshold(S):
    """A threshold equal to one sample's transmittance, on dyadic inputs
    (every csum exact, so the plain version's T has the same bits): that
    sample is excluded (T > thr fails) and its predecessor is
    included."""
    rng = np.random.default_rng(70 + S)
    inp = _inputs(rng, 16, S, 3, dyadic=True)
    sd = np.where(inp["valid"], inp["sigmas"] * inp["deltas"], 0).astype(f32)
    T = _exp(-(serial_csum(sd) - sd))
    r, j = 1, S // 2
    assert T[r, j - 1] > T[r, j] > 0
    thr = float(T[r, j])
    out = _check(_args(inp, True, True, 3), thr)
    assert out["ws"][r, j - 1] > 0 and out["ws"][r, j] == 0


def test_k3_fwd_model_csum_carries_across_segments():
    """Rays longer than one segment carry lane 0's sum: with the carry
    dropped, the second segment's csum (and so T) would restart at 0."""
    rng = np.random.default_rng(11)
    a = _args(_inputs(rng, 8, 100, 0), True, True, 0)
    _, cs = model_k3_fwd(a["sig"], a["dt"], a["ts"], a["valid"], 1e-4)
    sd = np.where(a["valid"], (a["sig"] * a["dt"]).astype(f32), f32(0))
    restart = np.concatenate([serial_csum(sd[:, s0:s0 + GROUP])
                              for s0 in range(0, 100, GROUP)], 1)
    assert not np.array_equal(cs[1], restart[1])
    np.testing.assert_array_equal(cs, serial_csum(sd))


def test_composite_without_ts_reads_no_depth():
    """ts=None: no depth, every other output as with ts; render_weights
    passes None (no zero plane) and returns composite's ws and Ts."""
    rng = np.random.default_rng(12)
    inp = {k: torch.from_numpy(v) for k, v in _inputs(rng, 30, 48, 3).items()}
    base = (inp["sigmas"], inp["deltas"])
    with_ts = k3.composite_fwd(*base, inp["ts"], inp["valid"], 1e-4,
                               inp["rgbs"], inp["aux"], with_Ts=True)
    no_ts = k3.composite_fwd(*base, None, inp["valid"], 1e-4, inp["rgbs"],
                             inp["aux"], with_Ts=True)
    assert set(with_ts) - set(no_ts) == {"depth"}
    for k, v in no_ts.items():
        assert torch.equal(v, with_ts[k]), k
    ws, Ts = ops.render_weights(*base, inp["valid"], 1e-4)
    assert torch.equal(ws, no_ts["ws"]) and torch.equal(Ts, no_ts["Ts"])
    sig = inp["sigmas"].clone().requires_grad_()
    with pytest.raises(ValueError):
        k3.composite(sig, inp["deltas"], None, inp["valid"], 1e-4,
                     inp["rgbs"])
