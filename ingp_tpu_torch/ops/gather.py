"""Mixed-precision table reads (counterpart of ingp_tpu/ops/gather.py,
forward only).

Tables are float32 masters; the encoders read a low-precision storage
copy made once per encoder call (`storage_cast`), halving the bytes of
every row fetch. The row reads themselves happen inside kernels K1 and
K2, which take the table and row ids, so the port has no separate
`table_gather`. The f32 scatter-add backward into the master table
comes with the training slice.
"""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def to_torch_dtype(dtype) -> torch.dtype:
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def storage_cast(table: torch.Tensor, storage_dtype=None):
    """Low-precision read copy of a master table, or None when the table
    already has the requested dtype (or none was requested)."""
    if storage_dtype is None:
        return None
    sd = to_torch_dtype(storage_dtype)
    if sd == table.dtype:
        return None
    return table.detach().to(sd)
