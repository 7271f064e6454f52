"""Logical-axis sharding rules (MaxText-style) for DP/FSDP/TP/EP/SP.

The counterpart of ``repro/distributed/sharding.py``.  Model code names
the dims of parameters and activations with *logical* axes; this module
maps them onto the named dims of a mesh.  A rule set is a dict
``logical_name -> mesh axis | tuple | None``, one for parameters and one
for activations: the same model dim (e.g. embed) is FSDP-sharded in
storage but replicated (or TP-sharded) in compute.

Robustness, as in the reference: when a logical dim is not divisible by
its mapped mesh-axis product, or the mesh axis is already consumed by an
earlier dim of the same tensor, the rule degrades to replication for that
dim, so every (arch x shape x mesh) cell runs, and the dry-run's record
then shows the cost of any degraded sharding.

A spec is a plain tuple, one entry per tensor dim (trailing ``None`` s
dropped): ``None``, a mesh-axis name, or a tuple of names.
:func:`placements` turns it into DTensor placements on a
``torch.distributed.DeviceMesh``; :func:`constrain` redistributes a
DTensor activation to its rule's layout inside :func:`use_mesh_rules` and
returns anything else unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch

Axes = Tuple[Optional[str], ...]
Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    params: Dict[str, Any]
    acts: Dict[str, Any]


def default_rules(fsdp: bool = True, multi_pod: bool = False) -> ShardingRules:
    """DP over (pod, data); TP over model; FSDP params over data; EP over
    model where divisible (divisibility fallback otherwise)."""
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    params = {
        "embed": "data" if fsdp else None,   # ZeRO-3 weight shard
        "vocab": "model",
        "q_heads": "model",
        "kv_heads": "model",
        "head": None,
        "mlp": "model",
        "experts": "model",                  # EP when divisible
        "heads": None,                       # ssm per-head scalars
        "conv": None,
        "layers": None,
        "seq": None,
    }
    acts = {
        "batch": batch_axes,
        "seq": None,                         # flip to "model" for SP
        "embed": None,                       # replicated over model (Megatron)
        "q_heads": "model",
        "kv_heads": "model",
        "head": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "kv_seq": None,
        "group": batch_axes,                 # MoE dispatch groups
    }
    return ShardingRules(params=params, acts=acts)


def sp_rules(fsdp: bool = True, multi_pod: bool = False) -> ShardingRules:
    """Sequence-parallel variant: shards the sequence dim over 'model' for
    the long-context cells (batch too small to fill the mesh)."""
    r = default_rules(fsdp=fsdp, multi_pod=multi_pod)
    acts = dict(r.acts)
    acts["seq"] = "model"
    acts["kv_seq"] = "model"
    return ShardingRules(params=r.params, acts=acts)


#: logical dims allowed to absorb the 'model' axis when the primary TP dim
#: (q/kv heads) is not divisible by it — e.g. whisper's 20 heads or GQA
#: kv=8 on a 16-way model axis
FALLBACK_TO_MODEL = ("head",)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, of a dict, or of any
    object whose ``shape`` is such a dict (the reference's ``Mesh``)."""
    if isinstance(mesh, dict):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def spec_for(axes: Axes, shape: Tuple[int, ...], rules: Dict[str, Any],
             mesh, head_fallback: bool = False) -> Spec:
    """The spec of a tensor of ``shape`` with logical ``axes``, with the
    divisibility and axis-reuse fallbacks (``sharding.py:97-135``).

    ``head_fallback``: let d_head absorb an unused 'model' axis — only for
    decode graphs (it shrinks KV caches replicated when kv_heads does not
    divide the model axis); the reference measured it harmful for train
    and prefill.
    """
    sizes = mesh_axes(mesh)
    used = set()
    parts: list = []
    for dim, name in zip(shape, axes):
        mapped = rules.get(name) if name else None
        if mapped is None:
            parts.append(None)
            continue
        cand = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        cand = tuple(a for a in cand if a in sizes and a not in used)
        total = math.prod(sizes[a] for a in cand)
        if not cand or total <= 1 or dim % total != 0:
            parts.append(None)
            continue
        used.update(cand)
        parts.append(cand[0] if len(cand) == 1 else cand)
    # second pass: if 'model' went unused, let a fallback dim absorb it
    if head_fallback and "model" in sizes and "model" not in used:
        for i, (dim, name) in enumerate(zip(shape, axes)):
            if parts[i] is None and name in FALLBACK_TO_MODEL and \
                    dim % sizes["model"] == 0:
                parts[i] = "model"
                break
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` with
    named dims): ``Shard(d)`` on each mesh dim that tensor dim ``d``'s
    entry names, ``Replicate()`` on the others.  A dim split over several
    mesh axes takes them major to minor, which must be the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def param_shardings(axes: Any, shapes: Any, rules: ShardingRules, mesh,
                    head_fallback: bool = False) -> Any:
    """A tree of :class:`NamedSharding` for a parameter tree: ``axes`` is
    its tree of logical axes, ``shapes`` the tree itself (tensors, e.g. on
    the meta device)."""
    from repro_torch.models.nn import tree_map   # models import this module
    return tree_map(
        lambda ax, t: NamedSharding(mesh, spec_for(
            ax, tuple(t.shape), rules.params, mesh,
            head_fallback=head_fallback)),
        axes, shapes)


def local_shape(shape: Tuple[int, ...], sharding: NamedSharding
                ) -> Tuple[int, ...]:
    """One device's shard of a ``shape`` tensor laid out as ``sharding``
    (every split divides: :func:`spec_for` makes only such splits)."""
    sizes = mesh_axes(sharding.mesh)
    out = list(shape)
    for d, entry in enumerate(sharding.spec):
        if entry is not None:
            axes = (entry,) if isinstance(entry, str) else entry
            out[d] //= math.prod(sizes[a] for a in axes)
    return tuple(out)


def distribute(t: torch.Tensor, sharding: NamedSharding,
               requires_grad: bool = False):
    """``t`` as a DTensor laid out as ``sharding``.

    A meta tensor becomes a DTensor over an empty meta shard of this
    device's size (no data moves: the dry-run's arguments); any other
    tensor is this device's slice of ``t`` (every rank holds the whole
    ``t``, as a restored checkpoint does, so nothing is sent)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = sharding.placements
    if t.device.type == "meta":
        local = torch.empty(local_shape(tuple(t.shape), sharding),
                            dtype=t.dtype, device="meta")
        out = DTensor.from_local(local, sharding.mesh, pl, run_check=False,
                                 shape=t.shape, stride=t.stride())
    else:
        out = distribute_tensor(t.detach(), sharding.mesh, pl,
                                src_data_rank=None)
    return out.requires_grad_(requires_grad)


#: the redistributions made beyond the reference's ``constrain`` sites
#: (where the port lays a DTensor out by hand), in the order made: the
#: dry-run records them as ``replicated``
REDISTRIBUTIONS: list = []


def redistribute(x, pl: tuple, why: str):
    """``x.redistribute`` to placements ``pl`` (on its mesh), noted in
    :data:`REDISTRIBUTIONS` with ``why`` when it communicates (a
    replicated dim that becomes split is a local slice)."""
    if tuple(x.placements) == tuple(pl):
        return x
    if any(a != b and not a.is_replicate()
           for a, b in zip(x.placements, pl)):
        REDISTRIBUTIONS.append(f"{why}: {tuple(x.shape)} "
                               f"{_names(x.placements)} -> {_names(pl)}")
    return x.redistribute(x.device_mesh, pl)


def gather_params(p):
    """A layer's parameters laid out for compute: inside
    :func:`use_mesh_rules`, every DTensor leaf replicated over the
    activation rules' batch axes — ZeRO-3's all-gather of an FSDP-stored
    weight, made by the layer that uses it (inside its remat body, so the
    copy is freed with the layer and gathered again for the recompute);
    its gradient goes back reduce-scattered.  ``p`` (a tensor or a tree)
    unchanged otherwise."""
    state = active_mesh_rules()
    if state is None:
        return p
    from torch.distributed.tensor import Replicate

    from repro_torch.models.nn import tree_map
    mesh, rules = state
    batch = rules.acts.get("batch") or ()
    batch = (batch,) if isinstance(batch, str) else tuple(batch)

    def one(t):
        if not is_dtensor(t):
            return t
        pl = tuple(Replicate() if n in batch else q
                   for n, q in zip(mesh.mesh_dim_names, t.placements))
        return redistribute(t, pl, "zero3 gather")
    return tree_map(one, p)


def from_local(t: torch.Tensor, mesh, pl: tuple):
    """The DTensor whose shard on this device is ``t``, placed ``pl``
    (every split even, so its global shape and strides follow from
    ``t``'s)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, pl, run_check=False)


def to_local(t, mesh, pl: tuple, why: str, out: Optional[tuple] = None
             ) -> torch.Tensor:
    """This device's shard of ``t`` laid out as ``pl`` (through
    :func:`redistribute`); a plain ``t`` is the same on every device.

    ``out``: the placements of what the caller computes from the shard.
    On a mesh dim that ``pl`` replicates but ``out`` does not, each device
    uses the same shard to make a different output, so the shard's
    gradient there is a partial sum (DTensor would take it for a
    replicated one and drop the other devices' terms)."""
    from torch.distributed.tensor import Partial, Replicate
    if not is_dtensor(t):
        t = from_local(t, mesh, (Replicate(),) * mesh.ndim)
    t = redistribute(t, pl, why)
    if out is None:
        return t.to_local()
    return t.to_local(grad_placements=tuple(
        Partial() if p.is_replicate() and not o.is_replicate() else p
        for p, o in zip(pl, out)))


def rules_for(mesh) -> ShardingRules:
    """The rules active under :func:`use_mesh_rules`, else the default
    rules of ``mesh``'s axes."""
    state = active_mesh_rules()
    if state is not None:
        return state[1]
    return default_rules(multi_pod="pod" in mesh_axes(mesh))


def act_placements(axes: Axes, shape: Tuple[int, ...], mesh,
                   head_fallback: bool = False) -> tuple:
    """The placements on ``mesh`` of an activation of ``shape`` with
    logical ``axes`` under :func:`rules_for` — how a DTensor fork of the
    model lays out the local shards it computes on."""
    return placements(spec_for(axes, tuple(shape), rules_for(mesh).acts,
                               mesh, head_fallback), mesh)


def batch_placements(x) -> tuple:
    """The placements of DTensor ``x`` (B, ...) split over the batch axes
    only, every other dim replicated."""
    return act_placements(("batch",), (x.shape[0],), x.device_mesh)


def keep_dims(pl: tuple, dims) -> tuple:
    """``pl`` with the splits of tensor dims outside ``dims`` replicated,
    e.g. the positions (B, S) of a query (B, S, H, D) laid out as ``pl``."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if not isinstance(p, Shard) or p.dim in dims
                 else Replicate() for p in pl)


def split_by(pl: tuple, dim: int) -> Tuple[int, ...]:
    """The mesh dims on which ``pl`` splits tensor dim ``dim``."""
    from torch.distributed.tensor import Shard
    return tuple(i for i, p in enumerate(pl)
                 if isinstance(p, Shard) and p.dim == dim)


def shard_index(mesh, dims: Tuple[int, ...]) -> int:
    """This device's index among the shards that the mesh dims ``dims``
    (major to minor) cut a tensor dim into."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def _names(pl) -> str:
    return "[" + ", ".join(map(str, pl)) + "]"


# -- activation constraints (context-scoped) --------------------------------
#
# The active (mesh, rules) pair is a process-wide default with a
# thread-local override, as in the reference (``sharding.py:152-203``):
# entering ``use_mesh_rules`` installs the pair as the process default
# (visible to worker threads, e.g. the serving batch executor) and as this
# thread's override; a thread may nest its own context
# (``process_default=False``) without disturbing the others.

_ctx = threading.local()
_process_state: Optional[Tuple[Any, ShardingRules]] = None
_process_lock = threading.Lock()


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: ShardingRules, process_default: bool = True):
    """Activate ``(mesh, rules)`` for :func:`constrain`.

    ``process_default=False`` confines the pair to the entering thread."""
    global _process_state
    prev_local = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules)
    if process_default:
        with _process_lock:
            prev_process = _process_state
            _process_state = (mesh, rules)
    try:
        yield
    finally:
        _ctx.state = prev_local
        if process_default:
            with _process_lock:
                _process_state = prev_process


def active_mesh_rules() -> Optional[Tuple[Any, ShardingRules]]:
    """The (mesh, rules) ``constrain`` would use on this thread, or None."""
    state = getattr(_ctx, "state", None)
    if state is not None:
        return state
    with _process_lock:
        return _process_state


def constrain(x, axes: Axes, why: Optional[str] = None):
    """Lay a DTensor activation out by logical names
    (``with_sharding_constraint``): inside :func:`use_mesh_rules`,
    ``x.redistribute`` to the activation rules' placements (a collective
    when they differ).  Outside a context, or for a plain tensor, ``x``
    is returned unchanged.  ``why`` names a site the port adds to the
    reference's: its moves are noted in :data:`REDISTRIBUTIONS`."""
    state = active_mesh_rules()
    if state is None:
        return x
    if not is_dtensor(x):
        return x
    mesh, rules = state
    pl = placements(spec_for(axes, tuple(x.shape), rules.acts, mesh), mesh)
    if tuple(x.placements) == pl:
        return x
    if any(p.is_partial() and type(p).__name__ != "Partial"
           for p in x.placements):
        return _ReduceMasked.apply(x, mesh, pl)
    if why is not None:
        return redistribute(x, pl, why)
    return x.redistribute(mesh, pl)


class _ReduceMasked(torch.autograd.Function):
    """``x.redistribute(mesh, pl)`` of a masked partial sum (the output of
    a lookup in a vocab-sharded table), whose gradient goes back
    replicated on the partial dims: DTensor's own backward would turn a
    partial-sum gradient into a masked partial sum, which it cannot."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.mesh, ctx.src = mesh, x.placements
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        pl = tuple(Replicate() if p.is_partial() else p for p in ctx.src)
        return g.redistribute(ctx.mesh, pl), None, None
