"""LPIPS perceptual metric (AlexNet variant) in PyTorch (counterpart of
ingp_tpu/training/lpips.py).

The weights come from a self-contained `.npz`, the format both packages
share (conv weights in HWIO, as the JAX package stores them), written
once by

    python -m ingp_tpu_torch.utils.export_lpips lpips_alex.npz \\
        alexnet.pth alex.pth

and the distance is the JAX package's computation:

  1. inputs from [0, 1] to [-1, 1], then (x - shift) / scale;
  2. the AlexNet feature trunk (5 conv stages, a 3x3 stride-2 max pool
     with no padding before stages 2 and 3), tapping each post-ReLU map;
  3. each tap normalised over channels, f / sqrt(sum f^2 + 1e-10) (the
     epsilon inside the square root, as the JAX package has it; the
     `lpips` package adds it outside), and the squared difference;
  4. a 1x1 head per tap with its weights clamped at 0, a spatial mean,
     then the sum over taps.

The convolutions run in full float32: TF32 is switched off for cuDNN
inside `lpips` whatever the process has set, as `metrics.ssim` pins its
filter to float64. Nothing here reaches the network; a missing weights
file fails at CLI parse time (training/config.py).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as nnf

from ..core import prng
from ..device import resolve_device

# AlexNet feature trunk: (out_c, kernel, stride, pad, maxpool_before)
_ALEX = (
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
)

EXPECTED_KEYS = tuple(
    [f"conv{i}_w" for i in range(5)] + [f"conv{i}_b" for i in range(5)]
    + [f"lin{i}" for i in range(5)] + ["shift", "scale"])

# the ScalingLayer buffers (richzhang/PerceptualSimilarity lpips.py)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def params_from_numpy(raw, device=None) -> dict:
    """The port's parameters from the shared layout (a dict or npz of
    numpy arrays, conv weights HWIO): float32 tensors, conv weights
    OIHW."""
    out = {}
    for k in EXPECTED_KEYS:
        a = np.asarray(raw[k], np.float32)
        if k.endswith("_w"):
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.tensor(np.ascontiguousarray(a), device=device)
    return out


def load_lpips(path, device=None) -> dict:
    """Load exported LPIPS weights (.npz) onto `device` (the card unless
    the caller names another, `device.resolve_device`)."""
    device = resolve_device(device)
    raw = np.load(path)
    missing = [k for k in EXPECTED_KEYS if k not in raw]
    if missing:
        raise ValueError(
            f"{path} is not an exported LPIPS weights file "
            f"(missing {missing}); create one with "
            "`python -m ingp_tpu_torch.utils.export_lpips`")
    return params_from_numpy(raw, device)


def save_lpips(path, params) -> None:
    """Write the port's parameters as an exported weights file (the
    shared layout, conv weights HWIO)."""
    np.savez(path, **{k: (v.permute(2, 3, 1, 0) if k.endswith("_w") else v)
                      .detach().cpu().numpy() for k, v in params.items()})


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _features(params, x):
    """AlexNet taps of (N, 3, H, W) normalised inputs."""
    taps = []
    for i, (_, _, stride, pad, pool_before) in enumerate(_ALEX):
        if pool_before:
            x = nnf.max_pool2d(x, 3, 2)
        x = torch.relu(nnf.conv2d(x, params[f"conv{i}_w"],
                                  params[f"conv{i}_b"], stride, pad))
        taps.append(x)
    return taps


def _unit_norm(f, eps=1e-10):
    return f / torch.sqrt((f * f).sum(1, keepdim=True) + eps)


def lpips(params, img0, img1):
    """LPIPS distance between (..., H, W, 3) images in [0, 1] (arrays or
    tensors), computed on the device of `params`. A scalar for one image
    pair, (N,) for a batch."""
    dev = params["shift"].device
    img0 = torch.as_tensor(img0, dtype=torch.float32, device=dev)
    img1 = torch.as_tensor(img1, dtype=torch.float32, device=dev)
    squeeze = img0.dim() == 3
    if squeeze:
        img0, img1 = img0[None], img1[None]
    shift = params["shift"].reshape(1, 3, 1, 1)
    scale = params["scale"].reshape(1, 3, 1, 1)

    def norm_in(im):
        return ((2.0 * im.permute(0, 3, 1, 2) - 1.0) - shift) / scale

    with _no_tf32():
        taps0 = _features(params, norm_in(img0))
        taps1 = _features(params, norm_in(img1))
    total = 0.0
    for i, (f0, f1) in enumerate(zip(taps0, taps1)):
        d = (_unit_norm(f0) - _unit_norm(f1)) ** 2          # (N, C, h, w)
        lin = torch.clamp(params[f"lin{i}"].reshape(1, -1, 1, 1), min=0.0)
        total = total + (d * lin).sum(1).mean((1, 2))
    return total[0] if squeeze else total


def random_lpips_params(key, seed_scale=0.1, device=None) -> dict:
    """Random weights of the production shapes from a `core.prng` key,
    drawn as the JAX package's `random_lpips_params` draws them (up to a
    few ulps of erfinv, `prng.normal`), for tests and for exercising
    the computation without the pretrained file. On the card unless the
    caller names another device."""
    device = resolve_device(device)
    params = {}
    cin = 3
    for i, (cout, k, _, _, _) in enumerate(_ALEX):
        key, k1, _ = prng.split(key, 3)
        w = seed_scale * prng.normal(k1, (k, k, cin, cout), device)
        params[f"conv{i}_w"] = w.permute(3, 2, 0, 1).contiguous()
        params[f"conv{i}_b"] = torch.zeros(cout, device=device)
        key, k3 = prng.split(key)
        params[f"lin{i}"] = torch.abs(
            seed_scale * prng.normal(k3, (cout,), device))
        cin = cout
    params["shift"] = torch.tensor(SHIFT, device=device)
    params["scale"] = torch.tensor(SCALE, device=device)
    return params
