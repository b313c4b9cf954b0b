"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

| wrapper | source | replaces (TPU kernel) |
|---|---|---|
| `rayreduce.fused_ray_reduce` (K1) | `csrc/rayreduce.cu` | `ingp_tpu/ops/pallas/rayreduce_pallas.py` `fused_ray_reduce` |
| `brickreduce.brick_reduce` (K2) | `csrc/brickreduce.cu` | `ingp_tpu/ops/pallas/brickreduce_pallas.py` `fused_brick_reduce` |
| `composite.composite` (K3) | `csrc/composite.cu` | `ingp_tpu/ops/pallas/composite_pallas.py` `composite_pallas` |

Each wrapper runs its plain PyTorch version (same module, `*_plain`)
for CPU tensors, and for CUDA tensors launches its kernel or raises. It
counts its launches in a plain int attribute, `wrapper.launches`.
"""
