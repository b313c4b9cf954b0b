"""Small MLPs as plain parameter lists (counterpart of
ingp_tpu/models/mlp.py): a list of {"w": (in, out), "b": (out,)} layers
in the `mlp_init` order.

Matmuls in a low-precision compute dtype follow the JAX package's
`preferred_element_type=float32` form: inputs and weights are rounded
to the compute dtype, products and sums are float32, and the result
stays float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as nnf

from ..core import prng

_ACTS = {
    "relu": torch.relu,
    "softplus": nnf.softplus,
    "sigmoid": torch.sigmoid,
    "none": lambda x: x,
    "exp": torch.exp,
}


def mlp_init(dims, key, device=None):
    """dims: (in, hidden..., out) -> list of layer dicts, uniform in
    +-1/sqrt(fan_in) (torch.nn.Linear's default bound), drawn from the
    PRNG key as the JAX package's mlp_init draws them."""
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        key, kw, kb = prng.split(key, 3)
        bound = 1.0 / math.sqrt(a)
        layers.append({"w": prng.uniform(kw, (a, b), -bound, bound, device),
                       "b": prng.uniform(kb, (b,), -bound, bound, device)})
    return layers


def round_to(x, compute_dtype):
    """x rounded to compute_dtype, carried as float32."""
    if compute_dtype == torch.float32:
        return x.float()
    return x.to(compute_dtype).float()


def dot(h, w, compute_dtype):
    """h @ w with both operands rounded to compute_dtype, f32 result."""
    return round_to(h, compute_dtype) @ round_to(w, compute_dtype)


def mlp_apply(layers, x, hidden_act="relu", out_act="none",
              compute_dtype=torch.float32):
    """Sample-major MLP: x (N, in) -> (N, out) float32."""
    h_act, o_act = _ACTS[hidden_act], _ACTS[out_act]
    h = x
    n = len(layers)
    for i, lyr in enumerate(layers):
        h = dot(h, lyr["w"], compute_dtype) + lyr["b"].float()
        h = h_act(h) if i < n - 1 else o_act(h)
    return h


def mlp_apply_cm(layers, x, hidden_act="relu", out_act="none",
                 compute_dtype=torch.float32, x_cm=False):
    """Channel-major MLP output (out, N); x is (N, in), or (in, N) with
    x_cm."""
    return mlp_apply(layers, x.T if x_cm else x, hidden_act, out_act,
                     compute_dtype).T
