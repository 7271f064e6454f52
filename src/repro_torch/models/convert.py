"""Carry a model's configuration and weights across from plain values.

The JAX reference and this port share no objects.  A caller (or a test)
that holds a reference config passes ``dataclasses.asdict(cfg)``, and one
that holds reference parameters passes them as NumPy arrays
(every leaf as ``np.asarray``, stacked ``(L, ...)`` layer leaves — an
MoE layer's ``(L, E, d, f)`` experts among them — or ``(G, E, ...)``
group leaves);
these helpers rebuild the port's objects, so both packages compute the
same thing from the same weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import Device, resolve_device
from repro_torch.models.model import Params, check_ported, n_groups

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


def _unstack(tree: Dict[str, Any], n: int) -> list:
    """A tree of ``(n, ...)`` leaves -> ``n`` trees of its slices."""
    def one(sub, i):
        return {k: one(v, i) if isinstance(v, dict) else v[i]
                for k, v in sub.items()}
    return [one(tree, i) for i in range(n)]


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device: Device = None) -> Params:
    """The port's parameters from the reference's parameter tree.

    Stacked ``(L, ...)`` ``layers`` leaves are split at L only into the
    port's list of per-layer dicts (an MoE layer keeps its ``(E, d, f)``
    expert tensors whole), ``(G, E, ...)`` ``groups`` leaves into a list of G
    lists of E; every other subtree (a hybrid model's ONE ``shared`` block)
    is carried leaf for leaf.  Every tensor is cast to ``cfg.dtype`` (as
    the reference casts them at use) on ``device`` (``None``: the card).
    """
    check_ported(cfg)
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    stacked = ("layers", "groups")
    out = _tree({k: v for k, v in tree.items() if k not in stacked}, dtype,
                device)
    if "layers" in tree:
        out["layers"] = _unstack(_tree(tree["layers"], dtype, device),
                                 cfg.n_layers)
    if "groups" in tree:
        groups = _unstack(_tree(tree["groups"], dtype, device),
                          n_groups(cfg))
        out["groups"] = [_unstack(g, cfg.attn_every) for g in groups]
    return out
