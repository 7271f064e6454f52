"""Carry a model's configuration and weights across from plain values.

The JAX reference and this port share no objects.  A caller (or a test)
that holds a reference config passes ``dataclasses.asdict(cfg)``, and one
that holds reference parameters passes them as NumPy arrays
(every leaf as ``np.asarray``, stacked ``(L, ...)`` layer leaves — an
MoE layer's ``(L, E, d, f)`` experts among them — or ``(G, E, ...)``
group leaves);
these helpers rebuild the port's objects, so both packages compute the
same thing from the same weights.  :func:`train_state_from_numpy` carries a
training state across (float32 moments and master weights), and
:func:`tree_to_numpy` is the way back: a port tree of per-layer lists as
the reference's stacked arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import Device, resolve_device
from repro_torch.models.model import FAMILY_KEYS, Params
from repro_torch.models.nn import tree_leaves, tree_map

#: reference field name -> port field name
RENAMED = {"use_pallas": "use_kernels"}


def config_from_fields(d: Mapping[str, Any]) -> ModelConfig:
    """A port :class:`ModelConfig` from a reference config's fields.

    ``use_pallas`` (the Pallas kernel in the graph) becomes ``use_kernels``
    (the hand-written CUDA kernel); an unknown field raises.
    """
    fields = {RENAMED.get(k, k): v for k, v in d.items()}
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"fields unknown to repro_torch's ModelConfig: "
                         f"{unknown}")
    return ModelConfig(**fields)


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """One array as a tensor of ``dtype``; bfloat16 arrays (``ml_dtypes``,
    which torch cannot read) travel bit for bit as int16."""
    a = np.array(a)              # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _tree(tree: Mapping[str, Any], dtype, device) -> Dict[str, Any]:
    return {k: _tree(v, dtype, device) if isinstance(v, Mapping)
            else _tensor(v, dtype, device) for k, v in tree.items()}


def _unstack(tree: Dict[str, Any]) -> list:
    """A tree of ``(n, ...)`` leaves -> ``n`` trees of its slices."""
    n = len(next(iter(tree_leaves(tree))))

    def one(sub, i):
        return {k: one(v, i) if isinstance(v, dict) else v[i]
                for k, v in sub.items()}
    return [one(tree, i) for i in range(n)]


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device: Device = None) -> Params:
    """The port's parameters from the reference's parameter tree.

    Stacked ``(L, ...)`` leaves (``layers``; a VLM's ``cross``, whose
    scalar gates stack to ``(G,)``; an enc-dec model's ``enc_layers`` and
    ``dec_layers``) are split at their leading axis only into the port's
    list of per-layer dicts (an MoE layer keeps its ``(E, d, f)`` expert
    tensors whole), ``(G, E, ...)`` ``groups`` leaves into a list of G
    lists of E; every other subtree (a hybrid model's ONE ``shared`` block,
    the ``pos`` and ``enc_pos`` tables) is carried leaf for leaf.  Every
    tensor is cast to ``cfg.dtype`` (as the reference casts them at use)
    on ``device`` (``None``: the card).
    """
    return _params(tree, cfg, cfg.torch_dtype, resolve_device(device))


def _params(tree: Mapping[str, Any], cfg: ModelConfig, dtype: torch.dtype,
            device: torch.device) -> Params:
    """A params-shaped reference tree in the port's layout, every leaf a
    ``dtype`` tensor on ``device``."""
    if cfg.family not in FAMILY_KEYS:
        raise ValueError(f"unknown family {cfg.family}")
    stacked = FAMILY_KEYS[cfg.family]
    out = _tree({k: v for k, v in tree.items() if k not in stacked}, dtype,
                device)
    for key in stacked:
        layers = _unstack(_tree(tree[key], dtype, device))
        out[key] = [_unstack(g) for g in layers] if key == "groups" \
            else layers
    return out


def train_state_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                           device: Device = None):
    """The port's ``TrainState`` from the reference's ``state.tree()``,
    ``{"params", "opt": {"step", "mu", "nu", "master"}}`` as NumPy arrays:
    the params in ``cfg.dtype``, the moments and master weights in float32
    (all four laid out as :func:`params_from_numpy` lays out the params),
    the step an int32 0-d tensor, on ``device`` (``None``: the card)."""
    from repro_torch.training.optimizer import OptState
    from repro_torch.training.train_step import TrainState
    device = resolve_device(device)
    opt = tree["opt"]
    f32 = {k: _params(opt[k], cfg, torch.float32, device)
           for k in ("mu", "nu", "master")}
    step = torch.as_tensor(np.array(opt["step"]), dtype=torch.int32,
                           device=device)
    return TrainState(params=_params(tree["params"], cfg, cfg.torch_dtype,
                                     device),
                      opt=OptState(step=step, **f32))


def tree_to_numpy(tree: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """A params-shaped port tree (params, grads, moments) as the
    reference's: per-layer lists stacked to ``(L, ...)`` and ``groups`` to
    ``(G, E, ...)`` NumPy arrays, every float leaf float32 (bfloat16 widens
    exactly)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    def stack(layers):
        return tree_map(lambda *ls: np.stack(ls), *layers)
    out = {k: tree_map(host, v) for k, v in tree.items()}
    for key in FAMILY_KEYS[cfg.family]:
        layers = out[key]
        out[key] = stack([stack(g) for g in layers]) if key == "groups" \
            else stack(layers)
    return out
