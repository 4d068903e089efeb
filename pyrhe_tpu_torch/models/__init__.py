from .rhe import RHE, StreamingRHE

__all__ = ["RHE", "StreamingRHE"]
