"""pyrhe_tpu_torch — randomized Haseman-Elston regression on PyTorch + CUDA.

The PyTorch port of pyrhe_tpu (the JAX package beside it, which stays the
reference): RHE, RHE-DOM and GENIE, cached and streaming, with the SUMRHE
trace export, on one NVIDIA Hopper card, with hand-written CUDA kernels for
the fused genotype decode + moment products (ops/kernels.py, csrc/). The CPU runs the same path through the
kernels' plain PyTorch versions when asked for (device="cpu").

The model classes are imported on first use, so the host-only tools
(simulate_pheno, utils.generate_annot, utils.add_cov_pheno, io/) start
without importing torch.
"""
__version__ = "0.1.0"

from .utils.logger import Logger

_MODELS = ("RHE", "StreamingRHE", "RHE_DOM", "StreamingRHE_DOM", "GENIE",
           "StreamingGENIE")

__all__ = [*_MODELS, "Logger", "__version__"]


def __getattr__(name):
    if name in _MODELS:
        from . import models
        return getattr(models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
