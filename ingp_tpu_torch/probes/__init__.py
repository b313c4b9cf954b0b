"""Hopper microbenchmarks of the questions the TPU layout probes under
benchmarking/ asked, each with hand-written CUDA kernels
(kernels/csrc/probe_*.cu) and their plain PyTorch versions:

| module | TPU probe | kernel source |
|---|---|---|
| `kernel_split` | `probe_kernel_split.py` | `probe_split.cu` |
| `row_layouts` | `probe_row_layouts.py` | `probe_rows.cu` |
| `vmem_gather` | `probe_vmem_gather.py` | `probe_onchip.cu` |
| `gather_layouts` | `probe_gather_layouts.py` | `probe_gather.cu` |

Each runs as `python -m ingp_tpu_torch.probes.<module>` on the card
(`--device cpu` runs the plain versions only) and prints one line per
variant: its time, its bytes bound and the library call's time. Each
module's `cases()` is what `chip_smoke.py`'s "probes" phase checks.
"""
