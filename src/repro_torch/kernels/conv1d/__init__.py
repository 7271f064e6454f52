from repro_torch.kernels.conv1d.ops import conv1d_causal
from repro_torch.kernels.conv1d.ref import (conv1d_causal_plain,
                                            conv1d_causal_ref)

__all__ = ["conv1d_causal", "conv1d_causal_plain", "conv1d_causal_ref"]
