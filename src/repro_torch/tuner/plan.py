"""Execution plans and their cache keys.

A :class:`Plan` is everything ``StencilEngine`` needs beyond the spec
itself — the knobs SPIDER fixes at compile time.  A :class:`PlanKey`
identifies the tuning problem: the *stencil* (content fingerprint, not
object identity), the *input shape bucket* (next power of two per dim, so
nearby sizes share one plan), the *dtype*, the *device kind* (``cpu`` or
``cuda`` — a plan tuned on the CPU must not be trusted on the card), the
*coefficient mode* (constant weights vs a fingerprinted variable-coefficient
field), the *temporal block size*, the *candidate universe* and the
*partition geometry* (see :func:`mesh_desc`).

The schema is the reference's (``PLAN_SCHEMA = 4``, the same fields and
encoding), so the two packages' keys differ only where they must: ``dev``
and ``univ`` (``"torch"`` / ``"torch+cuda"``, never the reference's
``"jnp"`` / ``"jnp+pallas"``).  Serialized plans and keys carry the
version, so caches written by a future revision are skipped, not misread;
fields added later default when absent and unknown fields are ignored.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.stencil import StencilSpec
from repro_torch.core.transform import default_l
from repro_torch.device import Device, resolve_device

#: serialization schema for Plan dicts and PlanKey strings.
#:   1  (implicit) backend/L/fuse_rows/star_fast_path; unversioned keys
#:   2  + temporal_steps on Plan; versioned keys + coeff/steps fields
#:   3  + univ (backend-universe provenance) on PlanKey
#:   4  + mesh (partition geometry, e.g. "4x2") on PlanKey; v1–v3 keys
#:      decode as mesh="1" (single device)
PLAN_SCHEMA = 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """Tuned engine configuration (hashable; JSON round-trippable)."""

    backend: str
    L: int
    fuse_rows: bool = False
    star_fast_path: bool = True
    temporal_steps: int = 1

    def to_dict(self) -> dict:
        return {"schema": PLAN_SCHEMA,
                "backend": self.backend, "L": int(self.L),
                "fuse_rows": bool(self.fuse_rows),
                "star_fast_path": bool(self.star_fast_path),
                "temporal_steps": int(self.temporal_steps)}

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        """Tolerant decode: unknown fields ignored, missing fields default.

        Raises ValueError on a future schema or a structurally unusable
        dict — the cache loader turns that into a warn-and-skip.
        """
        schema = int(d.get("schema", 1))
        if schema > PLAN_SCHEMA:
            raise ValueError(
                f"plan schema {schema} is newer than supported "
                f"{PLAN_SCHEMA}")
        return cls(backend=str(d["backend"]), L=int(d["L"]),
                   fuse_rows=bool(d.get("fuse_rows", False)),
                   star_fast_path=bool(d.get("star_fast_path", True)),
                   temporal_steps=int(d.get("temporal_steps", 1)))

    @classmethod
    def default(cls, spec: StencilSpec, backend: str = "direct",
                L: int | None = None, temporal_steps: int = 1) -> "Plan":
        """The plan `StencilEngine(spec, backend)` would have used."""
        return cls(backend=backend,
                   L=L if L is not None else default_l(spec.radius),
                   temporal_steps=temporal_steps)

    def describe(self) -> str:
        """Compact human-readable form, e.g. ``cuda_sptc/L8/k4``."""
        out = f"{self.backend}/L{self.L}{'/fused' if self.fuse_rows else ''}"
        if self.temporal_steps != 1:
            out += f"/k{self.temporal_steps}"
        return out


def spec_fingerprint(spec: StencilSpec) -> str:
    """Content hash of a stencil spec (shape/ndim/radius/weights)."""
    h = hashlib.sha256()
    h.update(f"{spec.shape}|{spec.ndim}|{spec.radius}|".encode())
    h.update(np.ascontiguousarray(spec.weights, dtype=np.float64).tobytes())
    return h.hexdigest()[:16]


def coefficients_fingerprint(coefficients: Any) -> str:
    """Content hash of a variable-coefficient field (shape + values)."""
    c = np.ascontiguousarray(np.asarray(coefficients), dtype=np.float64)
    h = hashlib.sha256()
    h.update(f"{c.shape}|".encode())
    h.update(c.tobytes())
    return h.hexdigest()[:16]


def shape_bucket(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Round every dim up to the next power of two (min 1)."""
    return tuple(1 << max(0, int(np.ceil(np.log2(max(1, s))))) for s in shape)


def dtype_name(dtype: Any) -> str:
    """``torch.float32`` -> ``"float32"`` (the reference's spelling)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def mesh_desc(mesh: Any) -> str:
    """Canonical partition-geometry string for a plan key.

    ``"1"`` means single-device (no partitioning); a sharded run encodes
    its per-grid-axis shard counts, e.g. ``"8"`` (1-D mesh) or ``"4x2"``
    (2-D).  Accepts ``None``, an int, a tuple of shard counts, an
    already-encoded string, or anything mesh-shaped (``axis_names`` +
    ``shape`` attributes, i.e. a
    :class:`~repro_torch.distributed.halo.GridMesh`).  Extent-1 axes
    carry no partitioning and are dropped — a mesh of all-1 extents IS
    single-device execution and canonicalizes to ``"1"``.
    """
    if mesh is None:
        return "1"
    if isinstance(mesh, str):
        parts = [p for p in mesh.split("x") if p]
    elif isinstance(mesh, int):
        parts = [mesh]
    elif isinstance(mesh, (tuple, list)):
        parts = list(mesh)
    elif hasattr(mesh, "axis_names") and hasattr(mesh, "shape"):
        parts = [mesh.shape[name] for name in mesh.axis_names]
    else:
        raise TypeError(
            f"mesh must be None, an int, a tuple of shard counts, an "
            f"encoded string, or a mesh; got {type(mesh).__name__}")
    try:
        counts = [int(p) for p in parts]
    except (TypeError, ValueError):
        raise ValueError(f"unparseable mesh description {mesh!r}") from None
    if any(c < 1 for c in counts):
        raise ValueError(f"mesh shard counts must be >= 1, got {counts}")
    counts = [c for c in counts if c > 1]
    return "x".join(str(c) for c in counts) if counts else "1"


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Cache key for one tuning problem."""

    spec_fp: str
    bucket: Tuple[int, ...]
    dtype: str
    device: str
    coeff: str = "const"       # "const" | "var-<fingerprint>"
    steps: int = 1             # temporal block size the plan targets
    univ: str = "torch"        # candidate universe: "torch" | "torch+cuda"
    mesh: str = "1"            # partition geometry: "1" | "8" | "4x2" | ...

    def encode(self) -> str:
        """Stable string form used as the JSON dict key (schema-prefixed)."""
        shape = "x".join(str(s) for s in self.bucket)
        return (f"v{PLAN_SCHEMA};spec={self.spec_fp};shape={shape};"
                f"dtype={self.dtype};dev={self.device};"
                f"coeff={self.coeff};steps={int(self.steps)};"
                f"univ={self.univ};mesh={self.mesh}")

    @classmethod
    def decode(cls, s: str) -> "PlanKey":
        """Decode v1 (unversioned) through v4 keys; tolerate unknown fields.

        Keys older than v3 carry no universe field and decode as the
        reference's ``univ="jnp"``, so they can never hit a port lookup;
        keys older than v4 decode as ``mesh="1"``.

        Raises ValueError on a future-versioned or structurally corrupt
        key — the cache loader turns that into a warn-and-skip.
        """
        fields = s.split(";")
        if fields and "=" not in fields[0]:
            tag = fields[0]
            if not tag.startswith("v") or not tag[1:].isdigit():
                raise ValueError(f"unrecognized plan-key prefix {tag!r}")
            version = int(tag[1:])
            if version > PLAN_SCHEMA:
                raise ValueError(
                    f"plan-key schema {version} is newer than supported "
                    f"{PLAN_SCHEMA}")
            fields = fields[1:]
        parts = dict(field.split("=", 1) for field in fields if field)
        bucket = tuple(int(v) for v in parts["shape"].split("x") if v)
        return cls(spec_fp=parts["spec"], bucket=bucket,
                   dtype=parts["dtype"], device=parts["dev"],
                   coeff=parts.get("coeff", "const"),
                   steps=int(parts.get("steps", 1)),
                   univ=parts.get("univ", "jnp"),
                   mesh=parts.get("mesh", "1"))


def plan_key(spec: StencilSpec, shape: Tuple[int, ...], dtype: Any,
             device: Device = None, *,
             coefficients: Optional[Any] = None,
             temporal_steps: int = 1, mesh: Any = None) -> PlanKey:
    """The key of tuning ``spec`` on a halo-inclusive ``shape`` of ``dtype``
    on ``device`` (``None``: the card, raising without one); the key's
    device kind is that device's type, ``cpu`` or ``cuda``.  ``mesh``
    keys the halo-exchange-sharded path apart (see :func:`mesh_desc`)."""
    from repro_torch.kernels.dispatch import backend_universe
    dev = resolve_device(device)
    coeff = ("const" if coefficients is None
             else f"var-{coefficients_fingerprint(coefficients)}")
    return PlanKey(spec_fp=spec_fingerprint(spec),
                   bucket=shape_bucket(tuple(shape)),
                   dtype=dtype_name(dtype),
                   device=dev.type, coeff=coeff, steps=temporal_steps,
                   univ=backend_universe(dev), mesh=mesh_desc(mesh))
