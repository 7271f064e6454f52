"""Plain reference of a constant-coefficient stencil and its lower-precision control.

Written from the stencil's definition alone: an output point is the
weighted sum of the input points around it, ``y[i] = sum_k w[k] x[i + k]``
over the ``(2r+1)^d`` offsets of the weight array, and an iterated
solver re-pads every step's interior with a zero halo of width ``r``.
A ``temporal_steps=k`` call applies ``k`` steps to an input that carries a
``k*r`` halo, shrinking it by ``r`` per step, and re-pads once.

Nothing here imports the program under test: the benchmark hands the raw
weights it drew from the seed and its own inputs, and this module applies
the star mask and the normalisation itself.
"""
from __future__ import annotations

import numpy as np
import torch


def normalised_weights(raw: np.ndarray, shape: str) -> np.ndarray:
    """The stencil's weights from the raw draw: a star keeps only the axes
    through the centre; the weights are scaled to sum 1."""
    w = np.asarray(raw, dtype=np.float64).copy()
    if shape == "star":
        r = w.shape[0] // 2
        keep = np.zeros(w.shape, dtype=bool)
        for axis in range(w.ndim):
            idx = [r] * w.ndim
            idx[axis] = slice(None)
            keep[tuple(idx)] = True
        w = np.where(keep, w, 0.0)
    return w / w.sum()


def taps(w: np.ndarray) -> int:
    """Points each output reads with a non-zero weight."""
    return int(np.count_nonzero(w))


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (float32) rounded to ``precision``, kept in float32."""
    if precision == "float32":
        return x
    if precision == "tf32":      # 10 mantissa bits, round to nearest (away)
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def apply_valid(w: np.ndarray, x: torch.Tensor, precision: str = "float64"
                ) -> torch.Tensor:
    """One application without padding: ``x`` of shape ``n + 2r`` per axis
    gives the ``n`` interior points.

    ``float64`` is the reference.  A lower ``precision`` is the control:
    weights and inputs rounded to it, products summed in float32, as a
    tensor-core product of that precision would.
    """
    r = w.shape[0] // 2
    out_shape = tuple(s - 2 * r for s in x.shape)
    if precision == "float64":
        xs, acc_dtype = x.to(torch.float64), torch.float64
    else:
        xs, acc_dtype = _round(x.to(torch.float32), precision), torch.float32
    acc = torch.zeros(out_shape, dtype=acc_dtype, device=x.device)
    for offset in zip(*np.nonzero(w)):
        wk = float(w[offset])
        if precision != "float64":
            wk = float(_round(torch.tensor([wk], dtype=torch.float32),
                              precision)[0])
        window = tuple(slice(o, o + n) for o, n in zip(offset, out_shape))
        acc.add_(xs[window], alpha=wk)
    return acc


def iterate(w: np.ndarray, x: torch.Tensor, steps: int,
            temporal_steps: int = 1, precision: str = "float64"
            ) -> torch.Tensor:
    """``steps`` solver steps from ``x`` (halo included), the halo zeroed
    again after every ``temporal_steps`` of them."""
    if steps % temporal_steps:
        raise ValueError(f"steps={steps} is not a multiple of "
                         f"temporal_steps={temporal_steps}")
    halo = temporal_steps * (w.shape[0] // 2)
    for _ in range(steps // temporal_steps):
        for _ in range(temporal_steps):
            x = apply_valid(w, x, precision)
        x = torch.nn.functional.pad(x, (halo,) * (2 * x.dim()))
    return x
