"""PyTorch/CUDA port of `ingp_tpu` for one NVIDIA H100.

The layout mirrors `ingp_tpu/` module for module (`core/`, `data/`,
`grid/`, `ops/`, `models/`, `training/`, `utils/`, `train.py`) plus
`kernels/`, which holds the hand-written CUDA kernels that replace the
Pallas TPU kernels, and `quality_synthetic.py`, the port's quality gate
(the counterpart of benchmarking/quality_synthetic.py). The
public functions keep the JAX package's layouts (channel-major `(3, N)`,
`(F, R, K)` ...), so each function can be held against its JAX
counterpart on the same inputs.

Entry points run on the card (`device="cuda"`) unless the caller asks
for the CPU (`device="cpu"`), where every kernel wrapper runs its plain
PyTorch version instead.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
