"""The port's span: one ``torch.profiler.record_function`` range.

:func:`region` is the only span ``repro_torch`` opens.  Spans are on
exactly while a ``torch.profiler`` is active, so they share the profiler's
clock with the device ops of the same trace; with no profiler a span costs
one flag check.  Two families open it:

* the kernel wrappers, one region named after the wrapper
  (``KERNEL_REGIONS``) around the plain version (a CPU tensor) or the
  launch (a CUDA tensor).  On the card the region holds the launch alone:
  the wrapper's own torch ops (an output buffer, a dtype or contiguity
  copy) run outside it.  ``repro_torch.vet.lowering`` counts those regions
  as the programs of a call: whatever runs outside them is the work the
  engine does around its kernels.
* ``core/engine.py``'s ``StencilEngine`` (``ENGINE_SPANS``): one
  ``engine.iterate`` per ``iterate`` call, one ``engine.apply`` per engine
  call around its emitted function (the kernel regions nest inside it),
  one ``engine.pad`` per re-pad of ``iterate``; inside ``engine.apply``,
  ``engine.layout_copy`` around each copy the engine makes to give a
  kernel a unit column stride, and ``engine.accumulate`` around the
  per-RowOp loop's zero fill and each of its adds.  The launch audit walks
  through them, so the work inside them is counted as the engine's.
"""
from __future__ import annotations

import contextlib
from typing import ContextManager

import torch

#: region name -> the CUDA kernel (``csrc/``) its wrapper launches inside it
KERNEL_REGIONS = {
    "sptc_spmm_fused": "sptc_mma_kernel",
    "sptc_spmm_rows2d": "sptc_rows2d_kernel",
    "sptc_spmm_star2d": "sptc_star2d_kernel",
    "sptc_spmm_windows": "sptc_spmm_kernel",
    "windows_gemm": "windows_gemm_kernel",
    "stencil2d": "stencil2d_kernel",
    "conv1d_causal": "conv1d_causal_kernel",
}

#: the engine's spans, outermost first
ENGINE_SPANS = ("engine.iterate", "engine.apply", "engine.pad",
                "engine.layout_copy", "engine.accumulate")


def region(name: str) -> ContextManager:
    """The span ``name``: a profiler range while a profiler is active.

    With no profiler active this costs one flag check, where a bare
    ``record_function`` would enter the dispatcher on every call.
    """
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
