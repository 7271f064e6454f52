"""Engine backend -> CUDA kernel applicators + backend applicability.

``applicable_backends`` says which of the engine's backends can run a spec
on a device.  The plain torch backends (direct/gemm/sptc) run anywhere; the
``cuda_*`` backends join them only on a CUDA device of compute capability
9.0 or above, since their kernels are built for ``sm_90a``.
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

from repro_torch.core.stencil import StencilSpec

PLAIN_BACKENDS = ("direct", "gemm", "sptc")
CUDA_BACKENDS = ("cuda_direct", "cuda_gemm", "cuda_sptc")
MIN_CAPABILITY = (9, 0)


def applicable_backends(spec: StencilSpec,
                        device: Union[str, torch.device]) -> Tuple[str, ...]:
    """Backends able to execute ``spec`` on ``device``."""
    device = torch.device(device)
    out = list(PLAIN_BACKENDS)
    if device.type == "cuda" and \
            torch.cuda.get_device_capability(device) >= MIN_CAPABILITY:
        out.extend(CUDA_BACKENDS)
    return tuple(out)


def build(spec: StencilSpec, backend: str, L: int,
          device: Union[str, torch.device]) -> Callable:
    """Whole-stencil applicator for the 'cuda_direct' backend.

    The tap buffers are built here, once, on ``device``.
    """
    if backend != "cuda_direct":
        raise ValueError(f"dispatch.build handles cuda_direct, got {backend}")
    from repro_torch.kernels.stencil_direct.ops import (stencil1d, stencil2d,
                                                        stencil_taps)

    w = np.asarray(spec.weights)
    r = spec.radius

    if spec.ndim == 1:
        taps1 = stencil_taps(w, device)
        return lambda x: stencil1d(taps1, x)

    if spec.ndim == 2:
        taps2 = stencil_taps(w, device)
        return lambda x: stencil2d(taps2, x)

    # 3-D: decompose the leading axis (paper §3.2.1 row decomposition,
    # lifted one dimension): y[a] = sum_u stencil2d(w[u]) applied to x[a+u];
    # the kernel's batch axis runs every a of one slab in one launch.
    slabs = [(u, stencil_taps(w[u], device)) for u in range(2 * r + 1)
             if np.any(w[u] != 0)]

    def fn3d(x: torch.Tensor) -> torch.Tensor:
        n1 = x.shape[0] - 2 * r
        acc = None
        for u, taps in slabs:
            part = stencil2d(taps, x[u:u + n1])
            acc = part if acc is None else acc + part
        if acc is None:       # all-zero kernel: every slab skipped
            out_shape = (n1,) + tuple(s - 2 * r for s in x.shape[1:])
            return torch.zeros(out_shape, dtype=x.dtype, device=x.device)
        return acc
    return fn3d
