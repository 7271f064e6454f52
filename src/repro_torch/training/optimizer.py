"""AdamW with float32 master state, global-norm clipping, cosine schedule.

The counterpart of ``repro/training/optimizer.py``: the same configuration,
state and update, on trees of tensors (nested dicts and lists).  The
reference computes every scalar — the learning rate, the clip scale, the
bias corrections — as a float32 array; here they are float32 tensors on the
parameters' device, built op for op in the same order (Python floats would
compute them in float64, and a Python divisor lets torch multiply by its
reciprocal instead).  The per-leaf update runs in place with
``torch._foreach_*`` ops over chunks of leaves: ``mu``, ``nu`` and
``master`` are overwritten, as the reference's jitted step donates its
state; the grads passed in are overwritten too (scaled by the clip).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.models.nn import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32
#: leaves are updated in chunks of at most this many elements (1 GiB in
#: float32), which bounds the update's float32 temporaries to a few GiB
CHUNK = 1 << 28


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Any                  # float32 first moment, params-shaped
    nu: Any                  # float32 second moment
    master: Any              # float32 master weights


def _f32(x: float, device) -> torch.Tensor:
    """``x`` rounded to a float32 0-d tensor on ``device``: a fill on the
    device, no host-to-device copy (which would wait for the stream)."""
    return torch.full((), x, dtype=F32, device=device)


def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac``: a float32 0-d
    tensor on ``step``'s device (``optimizer.py:42-48``)."""
    dev = step.device
    warm = torch.minimum(step.to(F32) / _f32(max(oc.warmup_steps, 1), dev),
                         _f32(1.0, dev))
    prog = torch.clamp((step - oc.warmup_steps).to(F32)
                       / _f32(max(oc.total_steps - oc.warmup_steps, 1), dev),
                       0.0, 1.0)
    cos = _f32(oc.min_lr_frac, dev) + _f32((1 - oc.min_lr_frac) * 0.5, dev) \
        * (1 + torch.cos(_f32(math.pi, dev) * prog))
    return _f32(oc.lr, dev) * warm * cos


def init(params) -> OptState:
    """Zero moments and a float32 copy of ``params`` (never an alias, even
    of float32 params: the update writes ``master`` in place)."""
    leaf = tree_leaves(params)[0]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params),
        master=tree_map(lambda p: p.detach().to(F32, copy=True), params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    leaves = [g.float() for g in tree_leaves(tree)]
    norms = torch._foreach_norm(leaves)
    return torch.linalg.vector_norm(torch.stack(norms))


def _chunks(*lists: List[torch.Tensor]):
    """Parallel slices of ``lists`` of at most ``CHUNK`` elements each (a
    larger leaf alone)."""
    start, size = 0, 0
    for i, t in enumerate(lists[0]):
        if size and size + t.numel() > CHUNK:
            yield [lst[start:i] for lst in lists]
            start, size = i, 0
        size += t.numel()
    if start < len(lists[0]):
        yield [lst[start:] for lst in lists]


def apply(oc: OptConfig, state: OptState, grads, compute_dtype: torch.dtype
          ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step (``optimizer.py:62-94``).  ``grads`` are float32
    (cast by the caller) and are scaled in place; ``mu``, ``nu`` and
    ``master`` are updated in place.  Returns new ``compute_dtype`` params
    (copies of ``master``), the new state and ``{"grad_norm", "lr"}``;
    the reported grad norm is the one before clipping.  Weight decay
    applies to every leaf."""
    dev = state.step.device
    gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, dev), _f32(oc.clip_norm, dev)
                          / (gnorm + _f32(1e-9, dev)))
    step = state.step + 1
    lr = schedule(oc, step)
    b1, b2 = oc.betas
    bc1 = 1 - torch.pow(_f32(b1, dev), step.to(F32))
    bc2 = 1 - torch.pow(_f32(b2, dev), step.to(F32))
    eps = _f32(oc.eps, dev)

    flat_g = tree_leaves(grads)
    flat_mu, flat_nu = tree_leaves(state.mu), tree_leaves(state.nu)
    flat_m = tree_leaves(state.master)
    for g, mu, nu, m in _chunks(flat_g, flat_mu, flat_nu, flat_m):
        torch._foreach_mul_(g, scale)
        # mu = b1 * mu + (1 - b1) * g
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        # nu = b2 * nu + (1 - b2) * g^2
        tmp = torch._foreach_mul(g, g)
        torch._foreach_mul_(tmp, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, tmp)
        # m = m - lr * (mhat / (sqrt(vhat) + eps) + wd * m)
        vhat = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(vhat)
        torch._foreach_add_(vhat, eps)
        mhat = torch._foreach_div(mu, bc1)
        torch._foreach_div_(mhat, vhat)
        del vhat, tmp
        torch._foreach_add_(mhat, torch._foreach_mul(m, oc.weight_decay))
        torch._foreach_mul_(mhat, lr)
        torch._foreach_sub_(m, mhat)
    params = tree_unflatten(state.master, [m.to(compute_dtype, copy=True)
                                           for m in flat_m])
    new_state = OptState(step=step, mu=state.mu, nu=state.nu,
                         master=state.master)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
