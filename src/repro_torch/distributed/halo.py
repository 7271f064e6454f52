"""Distributed halo-exchange stencil execution.

Grids too large for one device are block-partitioned over a 1-D or 2-D
mesh of shards; every shard runs the SAME lowered program the
single-device path runs (``core/engine.emit(LoweredPlan)``), and shards
exchange width-``k·r`` halos through a transport
(:mod:`repro_torch.distributed.transport`), the counterpart of the
reference's ``lax.ppermute`` inside ``shard_map``:

  * **Two exchanges per partitioned axis.**  Shard ``i`` sends its high
    edge to ``i+1`` (its low halo there) and its low edge to ``i-1``.  The
    outermost shards receive zeros: the zero-flux boundary
    ``StencilEngine.iterate`` re-pads with, at no extra cost.
    ``repro_torch.vet`` certifies exactly 2 per partitioned axis per step.
  * **Interior first.**  The exchanges are issued before the interior
    step, and the interior reads only the shard's own block, so it carries
    no dependence on them; rim slabs ``3·k·r`` deep are recomputed from the
    exchanged halos.
  * **Corner halos ride along.**  Axes are exchanged in order, and a later
    axis sends edges of the already-extended block, so a diagonal
    neighbour's corner arrives through two hops: box stencils stay exact.
  * **Non-divisible grids.**  A dim that does not divide its mesh axis is
    trailing-padded to the next multiple, its phantom rows are zeroed after
    every step (the zero-flux convention holds under ``iterate``), and the
    output is cropped back.

Layout.  This process's shards live in one tensor ``(B, *shard dims,
*spatial)``, one shard dim per partitioned mesh axis, so each interior or
rim computation is ONE batched engine call for every shard and job (the
engine's batch axis); with :class:`LocalTransport` all shards share one
device.  A step writes into the halo-extended buffer of the next: the
state stays on the device across steps and the global grid is assembled
once, at the end.

API convention matches :class:`~repro_torch.core.engine.StencilEngine`:
``engine(x)`` consumes a halo-inclusive ``(N+2kr, ...)`` grid and returns
the ``(N, ...)`` interior update; ``iterate(u, steps)`` evolves an
interior grid with zero boundary.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.engine import emit
from repro_torch.core.ir import LoweredPlan
from repro_torch.core.stencil import StencilSpec
from repro_torch.core.transform import lower_spec
from repro_torch.distributed.transport import Transport, default_transport

__all__ = ["GridMesh", "ShardedStencilEngine", "grid_mesh"]

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """A mesh of grid shards: axis names ``sp0``, ``sp1``, ..., the shard
    count per axis (``shape``) and the device of each shard, row-major."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int] = dataclasses.field(hash=False)
    devices: Tuple[torch.device, ...]

    @property
    def parts(self) -> Tuple[int, ...]:
        return tuple(self.shape[n] for n in self.axis_names)


def _as_device(d: Any) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def grid_mesh(parts, devices: Optional[Sequence] = None) -> GridMesh:
    """A 1-D/2-D mesh for grid partitioning (axes ``sp0``, ``sp1``).

    ``parts`` is the per-axis shard count: ``8`` or ``(8,)`` partitions
    grid axis 0 eight ways; ``(4, 2)`` partitions axes 0 and 1.  Uses the
    first ``prod(parts)`` of ``devices`` (default: every visible CUDA
    device).  A device may repeat — ``[torch.device("cuda", 0)] * 4`` or
    ``["cpu"] * 8`` places several shards on one device, the counterpart of
    the reference's forced host devices.  Raises when there are fewer
    devices than shards.
    """
    parts = (int(parts),) if isinstance(parts, int) else tuple(
        int(p) for p in parts)
    if not parts or any(p < 1 for p in parts):
        raise ValueError(f"mesh shape must be positive ints, got {parts}")
    need = math.prod(parts)
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if devices is None else [_as_device(d) for d in devices])
    if len(devs) < need:
        raise ValueError(
            f"mesh {parts} needs {need} devices but only {len(devs)} are "
            f"available (one process can hold several shards on one device: "
            f"pass devices=[torch.device('cuda', 0)] * {need} or "
            f"['cpu'] * {need})")
    names = tuple(f"sp{i}" for i in range(len(parts)))
    return GridMesh(axis_names=names, shape=dict(zip(names, parts)),
                    devices=tuple(devs[:need]))


@dataclasses.dataclass(frozen=True)
class _Geometry:
    """Shard geometry of one global grid shape."""

    gshape: Tuple[int, ...]          # the global grid a step evolves
    padded: Tuple[int, ...]          # trailing-padded to shard multiples
    block: Tuple[int, ...]           # a shard's block (unpartitioned: global)
    ext: Tuple[int, ...]             # the block with its k·r halos


class ShardedStencilEngine:
    """Block-partitioned stencil applicator over a mesh of shards.

    ``mesh`` is a :class:`GridMesh` (1 or 2 axes, each partitioning one
    grid axis — by default grid axes ``0, 1`` in mesh axis order; override
    with ``grid_axes``) or an int / tuple of shard counts, passed to
    :func:`grid_mesh`.  Mesh axes of extent 1 are degenerate (no exchange,
    plain zero padding) and are dropped.

    The plan knobs (``backend``, ``L``, ``fuse_rows``, ``star_fast_path``,
    ``temporal_steps``) mean what they mean on ``StencilEngine``; the
    lowering is shared and untouched.  ``transport`` defaults to
    :func:`~repro_torch.distributed.transport.default_transport`; the engine
    runs on the transport's device in ``dtype``.  Variable coefficients are
    not supported (the per-field tables are fixed to the global shape and
    do not decompose over blocks).
    """

    def __init__(self, spec: StencilSpec, mesh, *,
                 backend: str = "direct", L: Optional[int] = None,
                 star_fast_path: bool = True, fuse_rows: bool = False,
                 temporal_steps: int = 1,
                 grid_axes: Optional[Sequence[int]] = None,
                 transport: Optional[Transport] = None,
                 dtype: torch.dtype = torch.float32) -> None:
        if isinstance(mesh, (int, tuple, list)):
            mesh = grid_mesh(mesh)
        if len(mesh.axis_names) > spec.ndim:
            raise ValueError(
                f"mesh has {len(mesh.axis_names)} axes but {spec.name} is "
                f"only {spec.ndim}-D")
        axes = (tuple(range(len(mesh.axis_names))) if grid_axes is None
                else tuple(int(a) for a in grid_axes))
        if len(axes) != len(mesh.axis_names):
            raise ValueError(
                f"grid_axes {axes} must name one grid axis per mesh axis "
                f"{mesh.axis_names}")
        if len(set(axes)) != len(axes) or not all(
                0 <= a < spec.ndim for a in axes):
            raise ValueError(
                f"grid_axes {axes} must be distinct axes of a "
                f"{spec.ndim}-D grid")
        self.spec = spec
        self.mesh = mesh
        self.backend = backend
        self.temporal_steps = temporal_steps
        self.dtype = dtype
        #: width of the exchanged halo: k·r (temporal blocking fuses k
        #: steps per exchange — communication amortizes with k)
        self.halo = temporal_steps * spec.radius
        # grid axis -> (mesh axis index, shard count); extent-1 axes are
        # single-device along that dim and need no exchange
        self._part: Dict[int, Tuple[int, int]] = {
            a: (m, int(mesh.shape[name]))
            for m, (a, name) in enumerate(zip(axes, mesh.axis_names))
            if int(mesh.shape[name]) > 1}
        #: grid axis -> its shard dim in (B, *shard dims, *spatial)
        self._shard_dim = {a: 1 + i for i, a in enumerate(
            a for a, _ in sorted(self._part.items(), key=lambda t: t[1][0]))}
        self.transport = (transport if transport is not None
                          else default_transport(mesh))
        self.device, self._coords = self.transport.bind(mesh)
        self.plan_ir: LoweredPlan = lower_spec(
            spec, backend=backend, L=L, star_fast_path=star_fast_path,
            fuse_rows=fuse_rows, temporal_steps=temporal_steps)
        self.L = self.plan_ir.L
        #: the per-shard program: the single-device emission, on a batch
        self._shard_step: Callable[[Tensor], Tensor] = emit(
            self.plan_ir, self.device, dtype)

    @property
    def n_shards(self) -> int:
        """Shards the grid is actually partitioned into."""
        return math.prod(n for _, n in self._part.values()) or 1

    def partition(self) -> Dict[int, int]:
        """Grid axis -> shard count (extent-1 axes omitted)."""
        return {a: n for a, (_, n) in self._part.items()}

    # -- public API ----------------------------------------------------------
    def __call__(self, x: Tensor) -> Tensor:
        """Halo-inclusive ``(N+2kr, ...)`` in, interior ``(N, ...)`` out.

        Matches ``StencilEngine.__call__`` to float tolerance (block-local
        tiling reassociates the reductions).
        """
        self._check(x, self.spec.ndim, f"{self.spec.ndim}-D")
        return self._halo_call(x[None])[0]

    def apply_batched(self, xs: Tensor) -> Tensor:
        """``(B, *spatial-with-halo)`` -> ``(B, *interior)``: every job
        partitioned over the mesh, all jobs in one pass (the batch axis
        stays unsharded)."""
        self._check(xs, self.spec.ndim + 1,
                    f"(B, *spatial) {self.spec.ndim + 1}-D")
        return self._halo_call(xs)

    def step(self, u: Tensor) -> Tensor:
        """One fused k-step on an interior grid with zero boundary."""
        self._check(u, self.spec.ndim, f"{self.spec.ndim}-D")
        return self._run(u[None], 1)[0]

    def iterate(self, u: Tensor, steps: int) -> Tensor:
        """Evolve ``steps`` steps, state staying on the device.

        Equals ``StencilEngine.iterate(F.pad(u, kr), steps)`` center-
        cropped: the zero re-pad per step there is exactly the zero-flux
        halo the exchange provides here.  ``steps`` must be a multiple of
        ``temporal_steps``.
        """
        k = self.temporal_steps
        if steps % k != 0:
            raise ValueError(
                f"steps={steps} must be a multiple of temporal_steps={k}")
        self._check(u, self.spec.ndim, f"{self.spec.ndim}-D")
        return self._run(u[None], steps // k)[0]

    # -- implementation ------------------------------------------------------
    def _check(self, x: Tensor, ndim: int, what: str) -> None:
        if x.device != self.device or x.dtype != self.dtype:
            raise ValueError(
                f"sharded engine built for {self.dtype} on {self.device}, "
                f"got {x.dtype} on {x.device}")
        if x.dim() != ndim:
            raise ValueError(f"{self.spec.name} needs a {what} input, got "
                             f"shape {tuple(x.shape)}")

    def _halo_call(self, xs: Tensor) -> Tensor:
        # the zero-flux step on the full halo-inclusive domain, center-
        # cropped, is exact: output point p reads inputs within distance
        # k·r, so every surviving point reads only real values
        h = self.halo
        y = self._run(xs, 1)
        return y[(slice(None),) + (slice(h, -h),) * self.spec.ndim]

    def _geometry(self, gshape: Tuple[int, ...]) -> _Geometry:
        """Trailing pads to shard-divisible extents + per-axis blocks."""
        h = self.halo
        padded, block = list(gshape), list(gshape)
        for a, (_, n) in self._part.items():
            np_a = -(-gshape[a] // n) * n
            b = np_a // n
            if b <= 2 * h:
                raise ValueError(
                    f"dim {a} of extent {gshape[a]} over {n} shards gives "
                    f"per-shard blocks of {b} rows, but the halo needs "
                    f"blocks > 2·k·r = {2 * h} (radius {self.spec.radius} × "
                    f"temporal_steps {self.temporal_steps}); use fewer "
                    f"shards along this axis or a larger grid")
            padded[a], block[a] = np_a, b
        return _Geometry(gshape=tuple(gshape), padded=tuple(padded),
                         block=tuple(block),
                         ext=tuple(s + 2 * h for s in block))

    def _center(self, buf: Tensor) -> Tensor:
        """The blocks inside a halo-extended buffer."""
        h, d = self.halo, self.spec.ndim
        nl = buf.dim() - d
        return buf[(slice(None),) * nl + tuple(
            slice(h, s - h) for s in buf.shape[nl:])]

    def _new_buffer(self, lead: Tuple[int, ...], geo: _Geometry) -> Tensor:
        """A halo-extended buffer whose physical pads (unpartitioned axes)
        are zero; halos along partitioned axes are written by each step."""
        h, nl = self.halo, len(lead)
        buf = torch.empty(lead + geo.ext, dtype=self.dtype,
                          device=self.device)
        for a in range(self.spec.ndim):
            if a not in self._part:
                buf.narrow(nl + a, 0, h).zero_()
                buf.narrow(nl + a, geo.ext[a] - h, h).zero_()
        return buf

    def _scatter(self, us: Tensor, geo: _Geometry) -> Tensor:
        """``(B, *gshape)`` -> this process's blocks in a new buffer."""
        d, nl = self.spec.ndim, 1 + len(self._shard_dim)
        if geo.padded != geo.gshape:
            pad: List[int] = []
            for a in reversed(range(d)):
                pad += [0, geo.padded[a] - geo.gshape[a]]
            us = F.pad(us, pad)
        # (B, *padded) -> (B, *shard dims, *block) as a view
        split: List[int] = [us.shape[0]]
        where: Dict[int, int] = {}
        for a in range(d):
            if a in self._part:
                where[a] = len(split)
                split += [self._part[a][1], geo.block[a]]
            else:
                split.append(geo.padded[a])
        v = us.reshape(split)
        order = [0] + [where[a] for a in sorted(
            self._shard_dim, key=self._shard_dim.get)]
        order += [i for i in range(1, len(split)) if i not in order]
        v = v.permute(order)
        for a, sd in self._shard_dim.items():
            c = self._coords[self._part[a][0]]
            if c is not None:
                v = v.narrow(sd, c, 1)
        buf = self._new_buffer(tuple(v.shape[:nl]), geo)
        self._center(buf).copy_(v)
        return buf

    def _assemble(self, buf: Tensor, geo: _Geometry) -> Tensor:
        """This process's final buffer -> the ``(B, *gshape)`` grid."""
        d = self.spec.ndim
        blocks = self.transport.gather(self._center(buf))
        order = [0]
        for a in range(d):
            if a in self._part:
                order.append(self._shard_dim[a])
            order.append(1 + len(self._shard_dim) + a)
        y = blocks.permute(order).reshape((blocks.shape[0],) + geo.padded)
        if geo.padded != geo.gshape:
            y = y[(slice(None),) + tuple(slice(0, s) for s in geo.gshape)]
        return y

    def _shards(self, x: Tensor) -> Tensor:
        """The per-shard program on every job and shard in ONE batched
        call: the leading (B, *shard dims) fold into the engine's batch."""
        nl = 1 + len(self._shard_dim)
        lead = x.shape[:nl]
        y = self._shard_step(x.flatten(0, nl - 1))
        return y.unflatten(0, lead)

    def _exchange(self, ext: Tensor, geo: _Geometry) -> None:
        """Fill the halos of the blocks in ``ext``: 2 shifts per partitioned
        axis.  Along later axes only the blocks are valid yet, earlier
        axes' halos are, so corner halos arrive through two hops."""
        h = self.halo
        nl = ext.dim() - self.spec.ndim
        paxes = sorted(self._part)
        for j, a in enumerate(paxes):
            b = geo.block[a]
            later = {a2: (h, h + geo.block[a2]) for a2 in paxes[j + 1:]}
            sd, m = self._shard_dim[a], self._part[a][0]
            self.transport.shift(_at(ext, nl, {**later, a: (b, b + h)}),
                                 _at(ext, nl, {**later, a: (0, h)}),
                                 sd, m, +1)
            self.transport.shift(_at(ext, nl, {**later, a: (h, 2 * h)}),
                                 _at(ext, nl, {**later, a: (b + h, b + 2 * h)}),
                                 sd, m, -1)

    def _step(self, ext: Tensor, out: Tensor, geo: _Geometry) -> None:
        """One fused k-step: ``ext`` holds the blocks (their halos are
        written here), the result goes to the blocks of ``out``."""
        h = self.halo
        nl = ext.dim() - self.spec.ndim
        paxes = sorted(self._part)
        self._exchange(ext, geo)                # issued first
        dst = self._center(out)
        block = {a: (h, h + geo.block[a]) for a in paxes}
        inner = {a: (h, geo.block[a] - h) for a in paxes}
        # interior: reads only the shard's own block (pre-exchange data)
        _at(dst, nl, inner).copy_(self._shards(_at(ext, nl, block)))
        # rim slabs: the h-deep faces, from the exchanged halos; slab j
        # spans the interior along earlier axes, the whole block along
        # later ones
        for j, a in enumerate(paxes):
            b = geo.block[a]
            early = {a2: block[a2] for a2 in paxes[:j]}
            early_out = {a2: inner[a2] for a2 in paxes[:j]}
            _at(dst, nl, {**early_out, a: (0, h)}).copy_(
                self._shards(_at(ext, nl, {**early, a: (0, 3 * h)})))
            _at(dst, nl, {**early_out, a: (b - h, b)}).copy_(
                self._shards(_at(ext, nl, {**early, a: (b - h, b + 2 * h)})))
        self._zero_phantom(dst, geo)

    def _zero_phantom(self, blocks: Tensor, geo: _Geometry) -> None:
        """Zero the rows past the true extent of a non-divisible axis, so
        later steps keep reading zero-flux values past the boundary."""
        nl = blocks.dim() - self.spec.ndim
        for a, (m, n) in self._part.items():
            b, real = geo.block[a], geo.gshape[a]
            if b * n == real:
                continue
            i0, r0 = divmod(real, b)        # first phantom shard and row
            sd, c = self._shard_dim[a], self._coords[m]
            if c is None:                   # every shard in this process
                blocks.narrow(sd, i0, 1).narrow(nl + a, r0, b - r0).zero_()
                if i0 + 1 < n:
                    blocks.narrow(sd, i0 + 1, n - i0 - 1).zero_()
            elif c == i0:
                blocks.narrow(nl + a, r0, b - r0).zero_()
            elif c > i0:
                blocks.zero_()

    def _steps(self, ext: Tensor, geo: _Geometry, nblocks: int) -> Tensor:
        """``nblocks`` fused steps from the buffer ``ext`` (the step path:
        the state stays in two halo-extended buffers); returns the buffer
        holding the result."""
        out = self._new_buffer(tuple(ext.shape[:ext.dim() - self.spec.ndim]),
                               geo)
        for _ in range(nblocks):
            self._step(ext, out, geo)
            ext, out = out, ext
        return ext

    def _run(self, us: Tensor, nblocks: int) -> Tensor:
        geo = self._geometry(tuple(int(s) for s in us.shape[1:]))
        return self._assemble(self._steps(self._scatter(us, geo), geo,
                                          nblocks), geo)


def _at(buf: Tensor, nl: int, spans: Dict[int, Tuple[int, int]]) -> Tensor:
    """``buf`` sliced to ``spans`` (grid axis -> [lo, hi)) after ``nl``
    leading dims."""
    idx = [slice(None)] * buf.dim()
    for a, (lo, hi) in spans.items():
        idx[nl + a] = slice(lo, hi)
    return buf[tuple(idx)]
