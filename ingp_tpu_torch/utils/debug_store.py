"""Process-wide debug value store (counterpart of
ingp_tpu/utils/debug_store.py, the reference's models/global_var.py).

A module-level dict: `init` resets it with the reference's three
gradient-log keys, `set_value` / `get_value` store and read a value, and
`record(key)` gives a callable that stores a detached CPU numpy copy of
the tensor (or array) it is handed, e.g. as a tensor's backward hook:
`t.register_hook(debug_store.record("dL_dt"))`.
"""
from __future__ import annotations

import numpy as np
import torch

_global_dict: dict = {}

REFERENCE_KEYS = ("log_dL_dsigmas", "log_dL_dnormals_diff",
                  "log_dL_dnormals_ori")


def init():
    """Clear the store and set the reference's keys to zeros((1,))."""
    _global_dict.clear()
    for key in REFERENCE_KEYS:
        _global_dict[key] = np.zeros([1], np.float32)


def set_value(key, value):
    _global_dict[key] = value


def get_value(key):
    return _global_dict[key]


def record(key):
    """A callable that stores a detached CPU numpy copy of its argument
    under key and returns None (so, as a backward hook, it leaves the
    gradient unchanged)."""
    def _record(value):
        if torch.is_tensor(value):
            value = value.detach().cpu().numpy()
        _global_dict[key] = np.array(value)
    return _record
