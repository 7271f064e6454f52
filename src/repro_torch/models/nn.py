"""Parameter initialisation: nested dicts of tensors, drawn from an explicit
``torch.Generator``.

The counterpart of ``repro/models/nn.py``'s ``ParamBuilder``: the same
shapes, the same fan-in scale over the leading axis and the same zeros /
ones inits.  ``torch.Generator`` and JAX's random keys give different numbers
from the same seed, so weights that must match the reference are carried
across with :func:`repro_torch.models.convert.params_from_numpy` instead.

Every parameter carries the reference's tuple of *logical axis names*
(``"embed"``, ``"q_heads"``, ``"mlp"``, ...), recorded by the builder and
laid out as a tree of the parameters' structure by :func:`axes_tree`;
``repro_torch.distributed.sharding`` maps the names onto mesh axes.  The
port keeps per-layer lists where the reference stacks layers, so a leaf's
axes are the reference's without its stacked ``"layers"`` dims.

On the meta device the builder makes empty tensors and draws nothing, so
a full-size tree costs no memory and no time (the reference's
``jax.eval_shape``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]
Axes = Tuple[Optional[str], ...]


class ParamBuilder:
    """Creates parameters of one dtype on one device from one generator
    (``None`` on the meta device, which draws nothing) and records each
    one's logical axes in ``axes``, keyed by the tensor's ``id``."""

    def __init__(self, generator: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device):
        device = torch.device(device)
        if device.type != "meta" and (generator is None or
                                      generator.device.type != device.type):
            raise ValueError(f"generator on "
                             f"{getattr(generator, 'device', None)} cannot "
                             f"draw parameters for {device}")
        self.generator = generator
        self.dtype = dtype
        self.device = device
        self.axes: Dict[int, Axes] = {}

    def param(self, shape: Tuple[int, ...], axes: Axes = None,
              init: str = "normal",
              scale: Optional[float] = None) -> torch.Tensor:
        """A (shape) parameter with logical ``axes`` (one name or None per
        dim): ``"zeros"``, ``"ones"`` or ``"normal"`` draws scaled by
        ``scale`` (default 1/sqrt(fan-in))."""
        if axes is None or len(axes) != len(shape):
            raise ValueError(f"axes {axes} vs shape {shape}")
        t = self._make(tuple(shape), init, scale)
        self.axes[id(t)] = tuple(axes)
        return t

    def _make(self, shape: Tuple[int, ...], init: str,
              scale: Optional[float]) -> torch.Tensor:
        if self.device.type == "meta":
            return torch.empty(shape, dtype=self.dtype, device=self.device)
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


def axes_tree(params: Params, axes: Dict[int, Axes]) -> Params:
    """A tree of ``params``' structure holding each leaf's axes tuple, as
    a :class:`ParamBuilder` recorded them (``nn.py:72-95``)."""
    def leaf_axes(t: torch.Tensor) -> Axes:
        ax = axes.get(id(t))
        if ax is None:
            raise KeyError(f"no axes recorded for a {tuple(t.shape)} leaf")
        if len(ax) != t.dim():
            raise ValueError(f"rank {t.dim()} vs axes {ax}")
        return ax
    return tree_map(leaf_axes, params)


def tree_leaves(tree: Any) -> list:
    """Every tensor of a nested dict / list of parameters."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a nested dict / list (and the matching
    leaves of ``rest``, trees of the same structure), in a tree of that
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(skeleton: Any, leaves) -> Any:
    """A tree of ``skeleton``'s structure holding ``leaves`` in the order
    :func:`tree_leaves` lists ``skeleton``'s."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), skeleton)


def count_params(params: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))
