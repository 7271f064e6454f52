"""Engine backend -> CUDA kernel applicators + backend applicability.

``applicable_backends`` is the tuner's candidate universe: which of the
engine's backends may execute a spec on a device.  On the CPU (and on a
card below compute capability 9.0) that is the plain torch backends
(direct/gemm/sptc).  On a card of capability 9.0 or above, where the
``cuda_*`` kernels built for ``sm_90a`` run, it is those three kernels
only: the plain backends are the kernels' plain versions there, and never
enter a plan.  Variable coefficients keep the plain backends on every
device — the kernels take constant coefficients, as the reference has no
Pallas path for them either.
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

from repro_torch.core.stencil import StencilSpec

PLAIN_BACKENDS = ("direct", "gemm", "sptc")
CUDA_BACKENDS = ("cuda_direct", "cuda_gemm", "cuda_sptc")
MIN_CAPABILITY = (9, 0)


def backend_universe(device: Union[str, torch.device]) -> str:
    """Provenance tag of the candidate universe tuning ran against.

    ``"torch+cuda"`` on a card where the ``cuda_*`` kernels run, else
    ``"torch"``.  Recorded in the tuner's plan key; it never equals the
    reference's ``"jnp"`` / ``"jnp+pallas"``, so plans of the two packages
    never meet.
    """
    device = torch.device(device)
    if device.type == "cuda" and \
            torch.cuda.get_device_capability(device) >= MIN_CAPABILITY:
        return "torch+cuda"
    return "torch"


def applicable_backends(spec: StencilSpec, device: Union[str, torch.device],
                        *, variable_coefficients: bool = False
                        ) -> Tuple[str, ...]:
    """Backends a plan for ``spec`` on ``device`` may use."""
    from repro_torch.kernels.stencil_direct.ops import MAX_RADIUS
    if variable_coefficients or backend_universe(device) == "torch":
        return PLAIN_BACKENDS
    if spec.radius > MAX_RADIUS:       # the direct kernel's instantiations
        return tuple(b for b in CUDA_BACKENDS if b != "cuda_direct")
    return CUDA_BACKENDS


def build(spec: StencilSpec, backend: str, L: int,
          device: Union[str, torch.device]) -> Callable:
    """Whole-stencil applicator for the 'cuda_direct' backend, on a batch
    ``(B, *spatial)`` like every engine emission.

    The tap buffers are built here, once, on ``device``.  A batch of 1-D or
    2-D grids is one launch (the kernel's batch axis; 1-D grids are the
    rows of a ``rh = 0`` problem), a batch of 3-D grids loops over its jobs.
    """
    if backend != "cuda_direct":
        raise ValueError(f"dispatch.build handles cuda_direct, got {backend}")
    from repro_torch.kernels.stencil_direct.ops import stencil2d, stencil_taps

    w = np.asarray(spec.weights)
    r = spec.radius

    if spec.ndim <= 2:
        taps = stencil_taps(w, device)
        return lambda xs, out=None: stencil2d(taps, xs, out=out)

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
    return lambda xs: torch.stack([fn3d(x) for x in xs])
