"""Decode-state caches — the families the port runs so far.

The counterpart of ``repro/serving/cache.py``.  An SSM cache is O(1) in
the sequence length: per layer a (B, H, P, N) float32 state and the last
K-1 raw conv inputs, stacked over layers as in the reference, plus the
scalar position.  The ring-buffer KV helpers wait for the attention
families (ROADMAP.md, Queue 1 item 10).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import Device, resolve_device
from repro_torch.models.model import check_ported

Cache = Dict[str, Any]


def _ssm_states(cfg: ModelConfig, n: int, batch: int, device) -> Cache:
    h, hd, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    ch = cfg.d_inner + 2 * ns
    return {
        "ssm": torch.zeros((n, batch, h, hd, ns), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((n, batch, cfg.conv_width - 1, ch),
                            dtype=cfg.torch_dtype, device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: Device = None) -> Cache:
    """An empty cache at ``pos`` 0 on ``device`` (``None``: the card).

    ``cache_len`` bounds the sequence; the SSM cache does not depend on it.
    """
    check_ported(cfg)
    device = resolve_device(device)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            **_ssm_states(cfg, cfg.n_layers, batch, device)}
