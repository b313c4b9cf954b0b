"""The native batch sampler (counterpart of ingp_tpu/native/): a C++
background thread that gathers training batches, built with g++ at first
use."""
from .loader import NativeBatchSampler, native_available

__all__ = ["NativeBatchSampler", "native_available"]
