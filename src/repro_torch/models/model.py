"""Full-model assembly — the families the port runs so far.

The counterpart of ``repro/models/model.py``:

  dense    [norm->attn, norm->mlp] x L                (starcoder2, chatglm3,
                                                       qwen3, phi3)
  moe      [norm->attn, norm->moe] x L                (granite-moe, mixtral)
  ssm      [norm->mamba2] x L                         (mamba2)
  hybrid   groups of `attn_every` mamba layers + one  (zamba2)
           weight-SHARED attention/MLP block applied
           after each group

The reference's ``lax.scan`` over stacked layer parameters is a Python loop
over lists of per-layer parameter dicts (a hybrid model's ``groups`` is a
list of lists); its sharding ``constrain`` is a no-op on one card and is
dropped.  The enc-dec and VLM families wait in ROADMAP.md (Queue 1) and
raise here.
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
    """Raise for a configuration the port does not run yet: the ``encdec``
    and ``vlm`` families, or learned position embeddings (no config of the
    ported families has them)."""
    if cfg.family in ("encdec", "vlm") or cfg.pos_emb == "learned":
        raise NotImplementedError(
            f"{cfg.name} (family {cfg.family!r}, pos_emb {cfg.pos_emb!r}) is "
            f"not ported to repro_torch yet; it is queued in ROADMAP.md, "
            f"Queue 1")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_dense_layer(pb: ParamBuilder, cfg: ModelConfig) -> Params:
    """Attention and an MLP, or an MoE when the config has experts
    (``model.py:58-68``)."""
    p = {
        "attn_norm": L.init_norm(pb, cfg),
        "attn": L.init_attention(pb, cfg),
        "mlp_norm": L.init_norm(pb, cfg),
    }
    if cfg.family == "moe" or cfg.n_experts > 0:
        p["moe"] = L.init_moe(pb, cfg)
    else:
        p["mlp"] = L.init_mlp(pb, cfg)
    return p


def _init_mamba_layer(pb: ParamBuilder, cfg: ModelConfig) -> Params:
    return {
        "norm": L.init_norm(pb, cfg),
        "mamba": S.init_mamba(pb, cfg),
    }


def init_params(cfg: ModelConfig, generator: Union[int, torch.Generator] = 0,
                device: Device = None) -> Params:
    """The parameter tree of ``cfg`` in ``cfg.dtype`` on ``device``.

    ``generator`` is a seed or a ``torch.Generator`` on ``device``'s type;
    ``device=None`` is the card (raises without one).  ``layers`` (dense,
    moe, ssm) is a list of per-layer dicts; ``groups`` (hybrid) a list of
    ``n_layers // attn_every`` lists of ``attn_every`` Mamba layers, and
    ``shared`` the ONE attention/MLP block applied after every group.
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
    if cfg.family in ("dense", "moe"):
        p["layers"] = [_init_dense_layer(pb, cfg)
                       for _ in range(cfg.n_layers)]
    elif cfg.family == "ssm":
        p["layers"] = [_init_mamba_layer(pb, cfg)
                       for _ in range(cfg.n_layers)]
    else:                                                   # hybrid
        ng = n_groups(cfg)
        p["groups"] = [[_init_mamba_layer(pb, cfg)
                        for _ in range(cfg.attn_every)] for _ in range(ng)]
        p["shared"] = _init_dense_layer(pb, cfg)
    return p


def n_groups(cfg: ModelConfig) -> int:
    """A hybrid model's number of Mamba groups (= shared-block uses)."""
    ng = cfg.n_layers // cfg.attn_every
    if ng * cfg.attn_every != cfg.n_layers:
        raise ValueError(f"attn_every {cfg.attn_every} does not divide "
                         f"n_layers {cfg.n_layers}")
    return ng


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _mamba_block(p, x: Tensor, cfg: ModelConfig, *, collect_state=False):
    h = L.apply_norm(p["norm"], x, cfg)
    if collect_state:
        y, st = S.apply_mamba(p["mamba"], h, cfg, return_state=True)
        return x + y, st
    return x + S.apply_mamba(p["mamba"], h, cfg), None


def _dense_block(p, x: Tensor, cfg: ModelConfig, q_pos: Tensor):
    """Attention then the MLP or MoE, each pre-normed and residual
    (``model.py:160-182``).  Returns the output, the MoE's aux loss (0.0
    without one) and the block's (K, V) (B, S, Kh, Dh), which prefill
    keeps."""
    hn = L.apply_norm(p["attn_norm"], x, cfg)
    q, k, v = L._qkv(p["attn"], hn, hn, cfg, q_pos, q_pos, True)
    o = L.attention_core(q, k, v, q_pos, q_pos, cfg, causal=True,
                         block_kv=cfg.attn_block_kv)
    x = x + L.out_proj(o, p["attn"]["wo"])
    h = L.apply_norm(p["mlp_norm"], x, cfg)
    aux = 0.0
    if "moe" in p:
        y, aux = L.apply_moe(p["moe"], h, cfg)
    else:
        y = L.apply_mlp(p["mlp"], h, cfg)
    return x + y, aux, (k, v)


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

    ``aux`` is the MoE layers' summed aux loss (0.0 without MoE layers).
    ``kv`` (the prefill cache) when ``collect_kv``, else None: a dense or
    MoE model's ``{"self": (K, V)}``, each (L,B,S,Kh,Dh); an SSM model's
    ``{"states": {"ssm": (L,B,h,p,n), "conv": (L,B,K-1,ch)}}``, the Mamba
    layers in order (a hybrid model's group-major, group x attn_every +
    layer); a hybrid model adds ``"shared": (K, V)``, each (G,B,S,Kh,Dh),
    one per application of the shared block.
    """
    check_ported(cfg)
    x = embed_tokens(params, cfg, tokens)
    b, s = tokens.shape
    q_pos = torch.arange(s, dtype=torch.int32,
                         device=tokens.device).expand(b, s)
    states, kvs, aux = [], [], 0.0
    if cfg.family in ("dense", "moe"):                  # model.py:243-251
        for pl in params["layers"]:
            x, a, kv = _dense_block(pl, x, cfg, q_pos)
            aux = aux + a
            if collect_kv:
                kvs.append(kv)
        logits = unembed(params, cfg, x)
        kv = ({"self": tuple(torch.stack(t) for t in zip(*kvs))}
              if collect_kv else None)
        return logits, aux, kv
    if cfg.family == "ssm":
        groups, shared = [params["layers"]], None
    else:                                                   # hybrid
        groups, shared = params["groups"], params["shared"]
    for gp in groups:
        for pl in gp:
            x, st = _mamba_block(pl, x, cfg, collect_state=collect_kv)
            states.append(st)
        if shared is not None:
            x, a, kv = _dense_block(shared, x, cfg, q_pos)
            aux = aux + a
            if collect_kv:
                kvs.append(kv)
    logits = unembed(params, cfg, x)
    kv = None
    if collect_kv:
        kv = {"states": {k: torch.stack([st[k] for st in states])
                         for k in ("ssm", "conv")}}
        if shared is not None:
            kv["shared"] = tuple(torch.stack(t) for t in zip(*kvs))
    return logits, aux, kv
