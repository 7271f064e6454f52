"""The train step: grad-accumulation microbatching, mixed precision, AdamW,
optional bf16 gradient compression.

The counterpart of ``repro/training/train_step.py`` on one device.  Grads
come from ``torch.autograd.grad`` on the compute-dtype parameter leaves and
are cast to float32; over microbatches they accumulate in a float32 tree
and are averaged, and the metrics are the last microbatch's (what the
reference's ``lax.scan`` leaves).  A memory input (enc-dec frames, VLM
patches) is split per microbatch with the tokens.  The optimizer updates
the state in place (the reference's jitted step donates it), so a state
handed to :func:`train_step` is consumed: use the one it returns.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import Device
from repro_torch.models import model as M
from repro_torch.models.nn import tree_leaves, tree_unflatten
from repro_torch.training import optimizer as O


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1          # grad-accum steps per train step
    aux_weight: float = 0.01
    grad_compress: bool = False    # bf16 round trip of the gradient tree
    opt: O.OptConfig = dataclasses.field(default_factory=O.OptConfig)


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt: O.OptState

    def tree(self) -> Dict[str, Any]:
        """The checkpointed tree: ``{"params", "opt": {step, mu, nu,
        master}}``."""
        return {"params": self.params, "opt": self.opt._asdict()}

    @classmethod
    def from_tree(cls, tree: Dict[str, Any]) -> "TrainState":
        return cls(params=tree["params"], opt=O.OptState(**tree["opt"]))


def init_state(cfg: ModelConfig, generator=0,
               device: Device = None) -> TrainState:
    """Parameters from ``M.init_params(cfg, generator, device)`` and a fresh
    optimizer state (``device=None``: the card)."""
    params = M.init_params(cfg, generator, device=device)
    return TrainState(params=params, opt=O.init(params))


def _microbatch(tokens: torch.Tensor, n: int, memory):
    """(B, S) -> n microbatches of (B/n, S) (and of the memory)."""
    b = tokens.shape[0]
    if b % n:
        raise ValueError(f"global batch {b} % microbatches {n} != 0")
    mem = [None] * n if memory is None else memory.chunk(n)
    return list(zip(tokens.chunk(n), mem))


def _one(cfg: ModelConfig, tc: TrainConfig, params, tokens, memory):
    """Loss, metrics and the compute-dtype grads (a list, in
    ``tree_leaves`` order) of one microbatch."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = M.lm_loss(tree_unflatten(params, leaves), cfg, tokens,
                              memory=memory, aux_weight=tc.aux_weight)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, list(grads)


def loss_and_grads(cfg: ModelConfig, tc: TrainConfig, params, tokens,
                   memory=None):
    """``(loss, metrics, grads)``: the float32 grad tree (params-shaped),
    averaged over ``tc.microbatches`` (``train_step.py:62-92``)."""
    if tc.microbatches == 1:
        loss, metrics, grads = _one(cfg, tc, params, tokens, memory)
        return loss, metrics, tree_unflatten(params,
                                             [g.float() for g in grads])
    loss_sum, acc = 0.0, None
    for tok, mem in _microbatch(tokens, tc.microbatches, memory):
        loss, metrics, grads = _one(cfg, tc, params, tok, mem)
        loss_sum = loss_sum + loss
        if acc is None:
            acc = [g.float() for g in grads]
        else:   # a bf16 grad widens exactly as it is added
            torch._foreach_add_(acc, grads)
        del grads
    torch._foreach_mul_(acc, 1.0 / tc.microbatches)
    return loss_sum * (1.0 / tc.microbatches), metrics, \
        tree_unflatten(params, acc)


def train_step(cfg: ModelConfig, tc: TrainConfig, state: TrainState,
               tokens: torch.Tensor, memory=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on ``tokens`` (B, S+1).  ``state`` is updated in
    place and must not be used again; the returned state holds new
    compute-dtype params.  Metrics: ``loss``, ``nll``, ``aux``,
    ``grad_norm`` (before clipping) and ``lr``, 0-d tensors on the
    device."""
    loss, metrics, grads = loss_and_grads(cfg, tc, state.params, tokens,
                                          memory)
    if tc.grad_compress:
        # numerics of the reference's cross-pod compression: the averaged
        # tree rounded to bf16 and back
        for g in tree_leaves(grads):
            g.copy_(g.to(torch.bfloat16))
    params, opt, opt_metrics = O.apply(tc.opt, state.opt, grads,
                                       cfg.torch_dtype)
    return TrainState(params=params, opt=opt), \
        {"loss": loss, **metrics, **opt_metrics}


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """``step(state, tokens, memory=None)`` with the configs bound."""
    @functools.wraps(train_step)
    def step(state, tokens, memory=None):
        return train_step(cfg, tc, state, tokens, memory)
    return step
