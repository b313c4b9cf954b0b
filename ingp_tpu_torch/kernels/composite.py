"""K3: per-ray volume composite with the aux composites folded in.

Replaces the forward of ingp_tpu/ops/pallas/composite_pallas.py
`composite_pallas` (and the XLA `render_weights` / `composite_rays`
that the JAX main path runs). The CUDA kernel (`csrc/composite.cu`)
walks one ray per thread; it is bound by bytes moved (see the source's
note).
"""
from __future__ import annotations

import torch

from . import build


def composite_plain(sigmas, deltas, ts, valid, T_threshold: float,
                    rgbs=None, aux=None, with_Ts: bool = False):
    """Plain PyTorch version of `composite` (same contract)."""
    sd = torch.where(valid, sigmas * deltas, 0.0)
    csum = torch.cumsum(sd, -1)
    Ts = torch.exp(-(csum - sd))
    include = valid & (Ts > T_threshold)
    ws = torch.where(include, (1.0 - torch.exp(-sd)) * Ts, 0.0)
    out = {
        "ws": ws,
        "opacity": ws.sum(-1),
        "depth": (ws * ts).sum(-1),
        "count": (ws > 0).sum(-1).to(torch.int32),
    }
    if with_Ts:
        out["Ts"] = Ts
    if rgbs is not None:
        out["rgb"] = (ws[None] * rgbs).sum(-1).T
    if aux is not None:
        out["aux"] = (ws[None] * aux).sum(-1).T
    return out


def composite(sigmas, deltas, ts, valid, T_threshold: float, rgbs=None,
              aux=None, with_Ts: bool = False):
    """Front-to-back composite of (R, S) sample segments.

    Args:
      sigmas, deltas, ts: (R, S) f32; valid: (R, S) bool.
      rgbs: (3, R, S) f32 or None; aux: (C, R, S) f32 or None (extra
        channels composited with the same weights, e.g. normals and
        semantics).
      with_Ts: also return the transmittance before each sample.

    Returns dict ws (R, S), opacity (R,), depth (R,), count (R,) int32
    (samples with w > 0), and rgb (R, 3), aux (R, C), Ts (R, S) when
    asked. A sample is included iff valid and T > T_threshold, as in
    ingp_tpu's render_weights."""
    if sigmas.device.type == "cpu":
        return composite_plain(sigmas, deltas, ts, valid, T_threshold, rgbs,
                               aux, with_Ts)
    if sigmas.device.type != "cuda":
        raise ValueError(f"composite: unsupported device {sigmas.device}")
    dev = sigmas.device
    for name, t in (("sigmas", sigmas), ("deltas", deltas), ("ts", ts)):
        build.check_cuda_tensor(name, t, (torch.float32,), 2, dev)
    build.check_cuda_tensor("valid", valid, (torch.bool,), 2, dev, align=1)
    R, S = sigmas.shape
    for name, t in (("deltas", deltas), ("ts", ts), ("valid", valid)):
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
        "depth": torch.empty((R,), device=dev),
        "count": torch.empty((R,), dtype=torch.int32, device=dev),
    }
    if with_Ts:
        out["Ts"] = torch.empty((R, S), device=dev)
    if rgbs is not None:
        out["rgb"] = torch.empty((R, 3), device=dev)
    if aux is not None:
        out["aux"] = torch.empty((R, C), device=dev)
    if R == 0:
        return out
    with torch.cuda.device(dev):
        build.launch("ingp_composite_fwd", build.ptr(sigmas),
                     build.ptr(deltas), build.ptr(ts), build.ptr(valid),
                     build.ptr(rgbs), build.ptr(aux), C, float(T_threshold),
                     R, S, build.ptr(out["ws"]), build.ptr(out.get("Ts")),
                     build.ptr(out["opacity"]), build.ptr(out["depth"]),
                     build.ptr(out.get("rgb")), build.ptr(out.get("aux")),
                     build.ptr(out["count"]), build.stream_of(dev))
    composite.launches += 1
    return out


composite.launches = 0
