"""K3: per-ray volume composite with the aux composites folded in.

Replaces the forward of ingp_tpu/ops/pallas/composite_pallas.py
`composite_pallas` (and the XLA `render_weights` / `composite_rays`
that the JAX main path runs). The CUDA kernel (`csrc/composite.cu`)
takes a ray per group of 16 lanes, its lanes the ray's samples in
segments of 16, and sums the include rule's csum serially, as the
thread-per-ray body it replaced did, so ws, Ts and count keep those
bits; it is bound by bytes moved (see the source's note). Without ts
(`render_weights`) it reads no ts plane and makes no depth.

The backward (`composite_bwd`, `csrc/composite.cu`) replaces
`_run_bwd` of composite_pallas.py: the closed form of
volumerendering.cu plus the dL/dws term, extended by the aux
composites, whose cotangents reach the samples as dAux * w and reach
dL/dws as sum_c dAux_c * aux_c. Its kernel takes a ray per warp and
keeps 9 floats per sample in shared memory, so S is at most
`BWD_MAX_S`. It decides which samples are included from the same
serially summed bits as the forward kernel. `composite` runs forward
and backward as one `torch.autograd.Function` when a gradient is
wanted.
"""
from __future__ import annotations

import torch

from . import build

# composite.cu: 8 rays per block, 9 floats per sample in 227 KB
BWD_MAX_S = 227 * 1024 // (4 * 9 * 8)


def alpha_of(sd):
    """A sample's alpha 1 - exp(-sd) (the reference's form), with exp(-sd)
    rounded once to float32 from a float64 exp: the float32 nearest the
    exact value on every device, as the kernels' `k3_alpha` takes it. The
    cancellation multiplies the error of exp(-sd) by 1/sd, so a float32
    exp one ulp off (as a device's may be where another's is not) moves
    alpha by 5e-5 of itself at sd ~1e-3, and every weight of a ray by that
    much where the field is flat (a fresh bf16 model's first step)."""
    return 1.0 - torch.exp(-sd.double()).float()


def composite_plain(sigmas, deltas, ts, valid, T_threshold: float,
                    rgbs=None, aux=None, with_Ts: bool = False):
    """Plain PyTorch version of `composite_fwd` (same contract)."""
    sd = torch.where(valid, sigmas * deltas, 0.0)
    csum = torch.cumsum(sd, -1)
    Ts = torch.exp(-(csum - sd))
    include = valid & (Ts > T_threshold)
    ws = torch.where(include, alpha_of(sd) * Ts, 0.0)
    out = {
        "ws": ws,
        "opacity": ws.sum(-1),
        "count": (ws > 0).sum(-1).to(torch.int32),
    }
    if ts is not None:
        out["depth"] = (ws * ts).sum(-1)
    if with_Ts:
        out["Ts"] = Ts
    if rgbs is not None:
        out["rgb"] = (ws[None] * rgbs).sum(-1).T
    if aux is not None:
        out["aux"] = (ws[None] * aux).sum(-1).T
    return out


def composite(sigmas, deltas, ts, valid, T_threshold: float, rgbs=None,
              aux=None, with_Ts: bool = False):
    """Front-to-back composite (see `composite_fwd`), differentiable
    w.r.t. sigmas, rgbs and aux through `CompositeFn` when grad mode is
    on and one of them requires a gradient; deltas, ts, valid and the
    outputs Ts and count carry no gradient."""
    sigmas, deltas, ts, valid, rgbs, aux = (
        None if t is None else t.contiguous()
        for t in (sigmas, deltas, ts, valid, rgbs, aux))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (sigmas, rgbs, aux)):
        if rgbs is None or ts is None:
            raise ValueError("composite: a gradient needs rgbs and ts")
        C = 0 if aux is None else aux.shape[0]
        aux_in = sigmas.new_empty((0,) + sigmas.shape) if aux is None \
            else aux
        ws, op, dp, rgb, aux_out, count, Ts = CompositeFn.apply(
            sigmas, rgbs, aux_in, deltas, ts, valid, float(T_threshold),
            with_Ts)
        out = {"ws": ws, "opacity": op, "depth": dp, "count": count,
               "rgb": rgb}
        if C:
            out["aux"] = aux_out
        if with_Ts:
            out["Ts"] = Ts
        return out
    return composite_fwd(sigmas, deltas, ts, valid, T_threshold, rgbs, aux,
                         with_Ts)


def composite_fwd(sigmas, deltas, ts, valid, T_threshold: float, rgbs=None,
                  aux=None, with_Ts: bool = False):
    """Front-to-back composite of (R, S) sample segments.

    Args:
      sigmas, deltas: (R, S) f32; ts: (R, S) f32 or None (no depth);
        valid: (R, S) bool.
      rgbs: (3, R, S) f32 or None; aux: (C, R, S) f32 or None (extra
        channels composited with the same weights, e.g. normals and
        semantics).
      with_Ts: also return the transmittance before each sample.

    Returns dict ws (R, S), opacity (R,), count (R,) int32 (samples
    with w > 0), depth (R,) when ts is given, and rgb (R, 3), aux (R, C),
    Ts (R, S) when asked. A sample is included iff valid and T >
    T_threshold, as in ingp_tpu's render_weights."""
    if sigmas.device.type == "cpu":
        return composite_plain(sigmas, deltas, ts, valid, T_threshold, rgbs,
                               aux, with_Ts)
    return launch_fwd("ingp_composite_fwd", sigmas, deltas, ts, valid,
                      T_threshold, rgbs, aux, with_Ts)


def launch_fwd(symbol: str, sigmas, deltas, ts, valid, T_threshold: float,
               rgbs=None, aux=None, with_Ts: bool = False):
    """`composite_fwd` on the card through launcher `symbol`, which takes
    the arguments of `ingp_composite_fwd` (the K1/K2/K3 split's old K3
    forward body does too)."""
    if sigmas.device.type != "cuda":
        raise ValueError(f"composite: unsupported device {sigmas.device}")
    dev = sigmas.device
    planes = [("sigmas", sigmas), ("deltas", deltas)] + (
        [] if ts is None else [("ts", ts)])
    for name, t in planes:
        build.check_cuda_tensor(name, t, (torch.float32,), 2, dev)
    build.check_cuda_tensor("valid", valid, (torch.bool,), 2, dev, align=1)
    R, S = sigmas.shape
    for name, t in planes[1:] + [("valid", valid)]:
        if t.shape != (R, S):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(R, S)}")
    if rgbs is not None:
        build.check_cuda_tensor("rgbs", rgbs, (torch.float32,), 3, dev)
        if rgbs.shape != (3, R, S):
            raise ValueError(f"rgbs shape {tuple(rgbs.shape)}")
    C = 0
    if aux is not None:
        build.check_cuda_tensor("aux", aux, (torch.float32,), 3, dev)
        C = aux.shape[0]
        if aux.shape[1:] != (R, S):
            raise ValueError(f"aux shape {tuple(aux.shape)}")
    out = {
        "ws": torch.empty((R, S), device=dev),
        "opacity": torch.empty((R,), device=dev),
        "count": torch.empty((R,), dtype=torch.int32, device=dev),
    }
    if ts is not None:
        out["depth"] = torch.empty((R,), device=dev)
    if with_Ts:
        out["Ts"] = torch.empty((R, S), device=dev)
    if rgbs is not None:
        out["rgb"] = torch.empty((R, 3), device=dev)
    if aux is not None:
        out["aux"] = torch.empty((R, C), device=dev)
    if R == 0:
        return out
    with torch.cuda.device(dev):
        build.launch(symbol, build.ptr(sigmas),
                     build.ptr(deltas), build.ptr(ts), build.ptr(valid),
                     build.ptr(rgbs), build.ptr(aux), C, float(T_threshold),
                     R, S, build.ptr(out["ws"]), build.ptr(out.get("Ts")),
                     build.ptr(out["opacity"]), build.ptr(out.get("depth")),
                     build.ptr(out.get("rgb")), build.ptr(out.get("aux")),
                     build.ptr(out["count"]), build.stream_of(dev))
    return out


def composite_bwd_plain(sigmas, deltas, ts, valid, T_threshold: float,
                        rgbs, aux, dws, dO, dD, dC, dAux):
    """Plain PyTorch version of `composite_bwd` (same contract), the
    closed form of composite_pallas.py `_bwd_kernel` in its order of
    operations, with the aux cotangents folded into dws first."""
    sd = torch.where(valid, sigmas * deltas, 0.0)
    csum = torch.cumsum(sd, -1)
    Ts = torch.exp(-(csum - sd))
    include = valid & (Ts > T_threshold)
    alpha = alpha_of(sd)
    ws = torch.where(include, alpha * Ts, 0.0)
    T_after = Ts * (1.0 - alpha)
    dwe = dws
    for c in range(aux.shape[0]):
        dwe = dwe + dAux[:, c, None] * aux[c]
    O = ws.sum(-1, keepdim=True)
    D = (ws * ts).sum(-1, keepdim=True)
    prefD = torch.cumsum(ws * ts, -1)
    acc = dO[:, None] * (1.0 - O) + dD[:, None] * (ts * T_after - (D - prefD))
    dww = dwe * ws
    suffix = dww.sum(-1, keepdim=True) - torch.cumsum(dww, -1)
    acc = acc + T_after * dwe - suffix
    for c in range(3):
        C = (ws * rgbs[c]).sum(-1, keepdim=True)
        pref = torch.cumsum(ws * rgbs[c], -1)
        acc = acc + dC[:, c, None] * (rgbs[c] * T_after - (C - pref))
    dsig = torch.where(include, deltas * acc, 0.0)
    return dsig, dC.T[:, :, None] * ws[None], dAux.T[:, :, None] * ws[None]


def composite_bwd(sigmas, deltas, ts, valid, T_threshold: float, rgbs, aux,
                  dws, dO, dD, dC, dAux):
    """Backward of the composite: cotangents dws (R, S), dO (R,), dD (R,),
    dC (R, 3) and dAux (R, C) of ws, opacity, depth, rgb and aux ->
    (dsigmas (R, S), drgbs (3, R, S), daux (C, R, S)). dsigmas is zero
    where a sample is not included (invalid, or T <= T_threshold)."""
    if sigmas.device.type == "cpu":
        return composite_bwd_plain(sigmas, deltas, ts, valid, T_threshold,
                                   rgbs, aux, dws, dO, dD, dC, dAux)
    if sigmas.device.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device "
                         f"{sigmas.device}")
    dev = sigmas.device
    R, S = sigmas.shape
    C = aux.shape[0]
    for name, t, nd in (("sigmas", sigmas, 2), ("deltas", deltas, 2),
                        ("ts", ts, 2), ("rgbs", rgbs, 3), ("aux", aux, 3),
                        ("dws", dws, 2), ("dO", dO, 1), ("dD", dD, 1),
                        ("dC", dC, 2), ("dAux", dAux, 2)):
        build.check_cuda_tensor(name, t, (torch.float32,), nd, dev)
    build.check_cuda_tensor("valid", valid, (torch.bool,), 2, dev, align=1)
    if (rgbs.shape != (3, R, S) or aux.shape[1:] != (R, S)
            or dws.shape != (R, S) or dC.shape != (R, 3)
            or dAux.shape != (R, C)):
        raise ValueError("composite_bwd: shape mismatch")
    if S > BWD_MAX_S:
        raise ValueError(f"composite_bwd: S = {S} > {BWD_MAX_S} samples")
    dsig = torch.empty((R, S), device=dev)
    drgb = torch.empty((3, R, S), device=dev)
    daux = torch.empty((C, R, S), device=dev)
    if R == 0:
        return dsig, drgb, daux
    with torch.cuda.device(dev):
        build.launch("ingp_composite_bwd", build.ptr(sigmas),
                     build.ptr(deltas), build.ptr(ts), build.ptr(valid),
                     build.ptr(rgbs), build.ptr(aux), C, float(T_threshold),
                     R, S, build.ptr(dws), build.ptr(dO), build.ptr(dD),
                     build.ptr(dC), build.ptr(dAux), build.ptr(dsig),
                     build.ptr(drgb), build.ptr(daux), build.stream_of(dev))
    return dsig, drgb, daux


class CompositeFn(torch.autograd.Function):
    """`composite_fwd` and `composite_bwd` as one autograd Function.

    Inputs (sigmas, rgbs, aux (C, R, S), deltas, ts, valid, thr,
    with_Ts); outputs (ws, opacity, depth, rgb, aux_out, count, Ts),
    where aux_out is (R, 0) when C = 0 and Ts is empty unless asked."""

    @staticmethod
    def forward(ctx, sigmas, rgbs, aux, deltas, ts, valid, thr, with_Ts):
        C = aux.shape[0]
        out = composite_fwd(sigmas, deltas, ts, valid, thr, rgbs,
                            aux if C else None, with_Ts)
        ctx.save_for_backward(sigmas, rgbs, aux, deltas, ts, valid)
        ctx.thr = thr
        aux_out = out["aux"] if C else sigmas.new_empty(
            (sigmas.shape[0], 0))
        Ts = out["Ts"] if with_Ts else sigmas.new_empty(0)
        ctx.mark_non_differentiable(out["count"], Ts)
        return (out["ws"], out["opacity"], out["depth"], out["rgb"],
                aux_out, out["count"], Ts)

    @staticmethod
    def backward(ctx, dws, dO, dD, dC, dAux, _count, _Ts):
        sigmas, rgbs, aux, deltas, ts, valid = ctx.saved_tensors
        dsig, drgb, daux = composite_bwd(
            sigmas, deltas, ts, valid, ctx.thr, rgbs, aux,
            dws.contiguous(), dO.contiguous(), dD.contiguous(),
            dC.contiguous(), dAux.contiguous())
        return dsig, drgb, daux, None, None, None, None, None

