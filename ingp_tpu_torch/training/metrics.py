"""Image metrics (counterpart of ingp_tpu/training/metrics.py): MSE,
PSNR, SSIM (Wang et al., gaussian window 11, sigma 1.5, k1 0.01, k2
0.03, valid filtering) and LPIPS (AlexNet, training/lpips.py; it needs
an exported weights file, which the CLI asks for with --eval_lpips)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf


def mse(image_pred, image_gt):
    return ((image_pred - image_gt) ** 2).mean()


def psnr(image_pred, image_gt, data_range=1.0):
    return -10.0 * torch.log10(mse(image_pred, image_gt) / data_range ** 2)


def _gaussian_kernel(size=11, sigma=1.5):
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img0, img1, data_range=1.0, kernel_size=11, sigma=1.5, k1=0.01,
         k2=0.03):
    """SSIM of (H, W, C) images, mean over pixels and channels. The
    filter is a depthwise convolution, run in float64 so that no TF32
    convolution path can round it."""
    kern = torch.as_tensor(_gaussian_kernel(kernel_size, sigma),
                           device=img0.device, dtype=torch.float64)

    def filt(x):
        x = x.to(torch.float64).permute(2, 0, 1)[:, None]     # (C,1,H,W)
        return nnf.conv2d(x, kern[None, None])[:, 0]

    mu0, mu1 = filt(img0), filt(img1)
    s00 = filt(img0 * img0) - mu0 * mu0
    s11 = filt(img1 * img1) - mu1 * mu1
    s01 = filt(img0 * img1) - mu0 * mu1
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * mu0 * mu1 + c1) * (2 * s01 + c2)
    den = (mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2)
    return (num / den).mean().to(torch.float32)


def lpips(img0, img1, weights_path=None, params=None):
    """LPIPS perceptual metric (AlexNet variant, training/lpips.py) of
    (..., H, W, 3) images in [0, 1], from `params` or else the weights
    file `weights_path` (loaded on the images' device when they are
    tensors, else on the card). Raises with guidance when given neither."""
    from .lpips import load_lpips, lpips as lpips_fn
    if params is None:
        if not weights_path:
            raise RuntimeError(
                "LPIPS needs pretrained weights which cannot be "
                "downloaded in a zero-egress environment. Export them "
                "once with `python -m ingp_tpu_torch.utils.export_lpips "
                "lpips_alex.npz ALEXNET.pth ALEX_LINS.pth` and pass "
                "--lpips_weights lpips_alex.npz.")
        params = load_lpips(weights_path, img0.device if torch.is_tensor(
            img0) else None)
    return lpips_fn(params, img0, img1)
