"""Carry a stencil's parameters across from plain NumPy / Python values.

The JAX reference package and this port share no objects: a caller (or a
test) that holds a reference ``StencilSpec`` or coefficient field passes
its fields as plain values, and these helpers rebuild the port's objects
from them, validated by the port's own constructors.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.stencil import StencilSpec


def spec_from_arrays(shape: str, ndim: int, radius: int,
                     weights) -> StencilSpec:
    """A :class:`StencilSpec` from its fields; the weights are copied with
    their dtype kept, so the lowered tables match the source bit for bit."""
    return StencilSpec(shape=str(shape), ndim=int(ndim), radius=int(radius),
                       weights=np.array(weights))


def coefficients_from_array(c) -> np.ndarray:
    """A variable-coefficient field (``out_shape + (2r+1,)*d``) as an owned
    float64 array; the engine checks it against its spec."""
    arr = np.array(c, dtype=np.float64)
    if arr.ndim < 2 or arr.ndim % 2 != 0:
        raise ValueError(f"a coefficient field has 2*d axes, got shape "
                         f"{arr.shape}")
    if not np.all(np.isfinite(arr)):
        raise ValueError("coefficient field holds non-finite values")
    return arr
