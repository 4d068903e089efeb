"""pyrhe_tpu_torch — randomized Haseman-Elston regression on PyTorch + CUDA.

The PyTorch port of pyrhe_tpu (the JAX package beside it, which stays the
reference): additive RHE, cached and streaming, on one NVIDIA Hopper card,
with hand-written CUDA kernels for the fused genotype decode + moment
products (ops/kernels.py, csrc/). The CPU runs the same path through the
kernels' plain PyTorch versions when asked for (device="cpu").
"""
__version__ = "0.1.0"

from .models import RHE, StreamingRHE
from .utils.logger import Logger

__all__ = ["RHE", "StreamingRHE", "Logger", "__version__"]
