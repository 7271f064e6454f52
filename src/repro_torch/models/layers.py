"""Norms (``repro/models/layers.py:26-44``): statistics in float32, the
result in the input dtype.  Attention, MLP and MoE wait for the attention
families (ROADMAP.md, Queue 1 item 10)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.nn import ParamBuilder


def init_norm(pb: ParamBuilder, cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    p = {"scale": pb.param((d,), init="ones")}
    if cfg.norm == "ln":
        p["bias"] = pb.param((d,), init="zeros")
    return p


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "ln":
        xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    if cfg.norm == "ln":
        y = y + p["bias"].float()
    return y.to(x.dtype)
