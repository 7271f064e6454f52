from repro_torch.kernels.stencil_direct.ops import (Taps, stencil1d, stencil2d,
                                                    stencil_taps)
from repro_torch.kernels.stencil_direct.ref import stencil2d_ref

__all__ = ["Taps", "stencil1d", "stencil2d", "stencil_taps", "stencil2d_ref"]
