"""Truncated-gradient activations (counterpart of
ingp_tpu/ops/activations.py): exact forward, backward from the input
clamped to [-7, 7] (exp) or [-15, 15] (tanh)."""
from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-7.0, 7.0))


class _TruncTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.tanh(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        t = torch.tanh(x.clamp(-15.0, 15.0))
        return g * (1.0 - t * t)


def trunc_exp(x):
    return _TruncExp.apply(x)


def trunc_tanh(x):
    return _TruncTanh.apply(x)
