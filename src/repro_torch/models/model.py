"""Full-model assembly — the families the port runs so far.

The counterpart of ``repro/models/model.py``:

  ssm      [norm->mamba2] x L                         (mamba2)

The reference's ``lax.scan`` over stacked layer parameters is a Python loop
over a list of per-layer parameter dicts; its sharding ``constrain`` is a
no-op on one card and is dropped.  The dense, MoE, hybrid, enc-dec and VLM
families wait in ROADMAP.md (Queue 1 item 10) and raise here.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import Device, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.nn import ParamBuilder

Params = Dict[str, Any]
Tensor = torch.Tensor


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration the port does not run yet: a family other
    than ``ssm``, or learned position embeddings (no ssm config has them)."""
    if cfg.family != "ssm" or cfg.pos_emb == "learned":
        raise NotImplementedError(
            f"{cfg.name} (family {cfg.family!r}, pos_emb {cfg.pos_emb!r}) is "
            f"not ported to repro_torch yet; it is queued in ROADMAP.md, "
            f"Queue 1 item 10")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_mamba_layer(pb: ParamBuilder, cfg: ModelConfig) -> Params:
    return {
        "norm": L.init_norm(pb, cfg),
        "mamba": S.init_mamba(pb, cfg),
    }


def init_params(cfg: ModelConfig, generator: Union[int, torch.Generator] = 0,
                device: Device = None) -> Params:
    """The parameter tree of ``cfg`` in ``cfg.dtype`` on ``device``.

    ``generator`` is a seed or a ``torch.Generator`` on ``device``'s type;
    ``device=None`` is the card (raises without one).  ``layers`` is a list
    of per-layer dicts.
    """
    check_ported(cfg)
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    pb = ParamBuilder(generator, cfg.torch_dtype, device)
    p: Params = {
        "embed": pb.param((cfg.vocab, cfg.d_model), scale=0.02),
        "final_norm": L.init_norm(pb, cfg),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = pb.param((cfg.d_model, cfg.vocab))
    p["layers"] = [_init_mamba_layer(pb, cfg) for _ in range(cfg.n_layers)]
    return p


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _mamba_block(p, x: Tensor, cfg: ModelConfig, *, collect_state=False):
    h = L.apply_norm(p["norm"], x, cfg)
    if collect_state:
        y, st = S.apply_mamba(p["mamba"], h, cfg, return_state=True)
        return x + y, st
    return x + S.apply_mamba(p["mamba"], h, cfg), None


def embed_tokens(p, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    return F.embedding(tokens, p["embed"]).to(cfg.torch_dtype)


def unembed(p, cfg: ModelConfig, x: Tensor) -> Tensor:
    """Final norm and the vocabulary projection; float32 logits.

    The reference asks its einsum for a float32 result from inputs in the
    model dtype; here both operands are widened first, which gives the same
    exact products and float32 sums (a bf16 matmul would round the logits).
    """
    x = L.apply_norm(p["final_norm"], x, cfg)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return torch.matmul(x.float(), w.to(x.dtype).float())


def forward(params: Params, cfg: ModelConfig, tokens: Tensor,
            collect_kv: bool = False):
    """tokens (B, S) -> (logits (B, S, V) float32, aux, kv).

    ``kv`` is ``{"states": {"ssm": (L,B,h,p,n), "conv": (L,B,K-1,ch)}}``
    when ``collect_kv`` (the prefill cache), else None.
    """
    check_ported(cfg)
    x = embed_tokens(params, cfg, tokens)
    states = []
    for pl in params["layers"]:
        x, st = _mamba_block(pl, x, cfg, collect_state=collect_kv)
        states.append(st)
    logits = unembed(params, cfg, x)
    kv = None
    if collect_kv:
        kv = {"states": {k: torch.stack([st[k] for st in states])
                         for k in ("ssm", "conv")}}
    return logits, 0.0, kv
