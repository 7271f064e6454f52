"""Parameter initialisation: nested dicts of tensors, drawn from an explicit
``torch.Generator``.

The counterpart of ``repro/models/nn.py``'s ``ParamBuilder``: the same
shapes, the same fan-in scale over the leading axis and the same zeros /
ones inits.  ``torch.Generator`` and ``jax.random`` give different numbers
from the same seed, so weights that must match the reference are carried
across with :func:`repro_torch.models.convert.params_from_numpy` instead.
Logical-axis metadata waits for the sharding port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


class ParamBuilder:
    """Creates parameters of one dtype on one device from one generator."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
        if generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device} cannot draw "
                             f"parameters for {device}")
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def param(self, shape: Tuple[int, ...], init: str = "normal",
              scale: Optional[float] = None) -> torch.Tensor:
        """A (shape) parameter: ``"zeros"``, ``"ones"`` or ``"normal"``
        draws scaled by ``scale`` (default 1/sqrt(fan-in))."""
        if init == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        if scale is None:
            # fan-in scaling over the contracted (leading) dim
            scale = 1.0 / np.sqrt(max(1, shape[0]))
        w = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return (w * scale).to(self.dtype)


def tree_leaves(tree: Any) -> list:
    """Every tensor of a nested dict / list of parameters."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def count_params(params: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))
