"""The port's span, one ``torch.profiler.record_function`` range, and the
kernel wrappers' check of an ``out`` argument.

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
  ``engine.pad`` around ``iterate``'s halo work (the zeroing of each of
  its two buffers' halos, or the fallback's re-pad); inside
  ``engine.apply``, ``engine.layout_copy`` around each copy the engine
  makes to give a kernel a unit column stride, and ``engine.accumulate``
  around the per-RowOp loop's zero fill and each of its adds.  The launch
  audit walks through them, so the work inside them is counted as the
  engine's.
"""
from __future__ import annotations

import contextlib
from typing import ContextManager, Sequence, Tuple

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


def _byte_span(t: torch.Tensor) -> Tuple[int, int]:
    """The first and one-past-last byte addresses ``t`` can touch."""
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()


def check_out(out: torch.Tensor, shape: Sequence[int],
              x: torch.Tensor) -> None:
    """Check a wrapper's ``out`` against the result it takes: ``shape``,
    ``x``'s dtype and device, a unit column stride, and no byte in the
    span of ``x`` (a step never writes what it reads)."""
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"out must be of shape {tuple(shape)}, got "
                         f"{tuple(out.shape)}")
    if out.dtype != x.dtype:
        raise TypeError(f"out dtype {out.dtype} != input dtype {x.dtype}")
    if out.device != x.device:
        raise ValueError(f"out lies on {out.device}, the input on {x.device}")
    if out.dim() and out.shape[-1] > 1 and out.stride(-1) != 1:
        raise ValueError("out needs a unit column stride")
    if out.numel() and x.numel():
        (o0, o1), (x0, x1) = _byte_span(out), _byte_span(x)
        if o0 < x1 and x0 < o1:
            raise ValueError("out overlaps the input")
