from .genie import GENIE, StreamingGENIE
from .rhe import RHE, StreamingRHE
from .rhe_dom import RHE_DOM, StreamingRHE_DOM

__all__ = ["RHE", "StreamingRHE", "RHE_DOM", "StreamingRHE_DOM", "GENIE",
           "StreamingGENIE"]
