"""Stencil problem specification.

A stencil is characterized (paper §2.1) by shape type (star | box),
dimensionality d and radius r. The stencil kernel is the (2r+1)^d weight
array; star stencils have non-zeros only along the axes through the center.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

SHAPES = ("star", "box")


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """Static description of a stencil computation.

    Attributes:
      shape: "star" or "box".
      ndim: spatial dimensionality (1, 2 or 3).
      radius: dependency radius r (order).
      weights: numpy array of shape (2r+1,)*ndim. For star stencils all
        entries off the axis cross are zero.
    """

    shape: str
    ndim: int
    radius: int
    weights: np.ndarray

    def __post_init__(self) -> None:
        if self.shape not in SHAPES:
            raise ValueError(f"shape must be one of {SHAPES}, got {self.shape}")
        if self.ndim not in (1, 2, 3):
            raise ValueError(f"ndim must be 1, 2 or 3, got {self.ndim}")
        if self.radius < 1:
            raise ValueError("radius must be >= 1")
        expect = (2 * self.radius + 1,) * self.ndim
        if tuple(self.weights.shape) != expect:
            raise ValueError(
                f"weights shape {self.weights.shape} != expected {expect}")
        if self.shape == "star" and not _is_star(self.weights, self.radius):
            raise ValueError("weights are not star-shaped")

    @property
    def taps(self) -> int:
        """Number of (potentially) non-zero points in the pattern."""
        if self.shape == "box":
            return (2 * self.radius + 1) ** self.ndim
        return 2 * self.radius * self.ndim + 1

    @property
    def name(self) -> str:
        return f"{self.shape}-{self.ndim}d{self.radius}r"


def _is_star(w: np.ndarray, r: int) -> bool:
    mask = np.zeros_like(w, dtype=bool)
    center = (r,) * w.ndim
    for axis in range(w.ndim):
        idx = list(center)
        idx[axis] = slice(None)
        mask[tuple(idx)] = True
    return bool(np.all(w[~mask] == 0))


def star_mask(ndim: int, radius: int) -> np.ndarray:
    """Boolean mask of the star pattern inside a (2r+1)^d cube."""
    w = np.ones((2 * radius + 1,) * ndim)
    mask = np.zeros_like(w, dtype=bool)
    center = (radius,) * ndim
    for axis in range(ndim):
        idx = list(center)
        idx[axis] = slice(None)
        mask[tuple(idx)] = True
    return mask


def make_stencil(shape: str, ndim: int, radius: int,
                 seed: int | None = 0,
                 weights: np.ndarray | None = None) -> StencilSpec:
    """Construct a stencil with given pattern. Random weights by default.

    Weights are drawn from U(0.1, 1.0) then normalized to sum 1 (a smoothing
    stencil — keeps iterated application numerically stable), matching common
    practice in the stencil benchmark literature (heat/jacobi kernels).
    """
    k = 2 * radius + 1
    if weights is None:
        rng = np.random.default_rng(seed)
        weights = rng.uniform(0.1, 1.0, size=(k,) * ndim)
    weights = np.asarray(weights, dtype=np.float64).copy()
    if shape == "star":
        weights = weights * star_mask(ndim, radius)
    weights = weights / weights.sum()
    return StencilSpec(shape=shape, ndim=ndim, radius=radius, weights=weights)


# The paper's benchmark suite (§4.1): 1D r∈{1,2}; 2D star/box r∈{1,2,3}.
PAPER_SUITE: Tuple[Tuple[str, int, int], ...] = (
    ("box", 1, 1),
    ("box", 1, 2),
    ("star", 2, 1),
    ("star", 2, 2),
    ("star", 2, 3),
    ("box", 2, 1),
    ("box", 2, 2),
    ("box", 2, 3),
)


def paper_suite() -> Tuple[StencilSpec, ...]:
    return tuple(make_stencil(s, d, r, seed=17 * d + r) for s, d, r in PAPER_SUITE)
