"""Full-model assembly — the families the port runs so far.

The counterpart of ``repro/models/model.py``:

  dense    [norm->attn, norm->mlp] x L                (starcoder2, chatglm3,
                                                       qwen3, phi3)
  moe      [norm->attn, norm->moe] x L                (granite-moe, mixtral)
  ssm      [norm->mamba2] x L                         (mamba2)
  hybrid   groups of `attn_every` mamba layers + one  (zamba2)
           weight-SHARED attention/MLP block applied
           after each group
  encdec   encoder [norm->bidi-attn, norm->mlp] x Le  (whisper; conv frontend
           decoder [self, cross, mlp] x L              stubbed to frame embeds)
  vlm      groups of `cross_attn_every` self layers   (llama-3.2-vision; patch
           after one gated cross-attn layer per group  embeds stubbed)

The reference's ``lax.scan`` over stacked layer parameters is a Python loop
over lists of per-layer parameter dicts (a hybrid or VLM model's
``groups`` is a list of lists); its sharding ``constrain`` is a no-op on
one card and is dropped.  Its remat (``jax.checkpoint`` of each scanned
body) is ``torch.utils.checkpoint`` around each layer body, applied when
autograd records the forward (see :func:`_remat`).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import Device, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.nn import ParamBuilder

Params = Dict[str, Any]
Tensor = torch.Tensor


#: the products that remat policy ``"dots"`` keeps (JAX's
#: ``checkpoint_dots``: every dot's output is saved, the rest recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _remat(cfg: ModelConfig, params: Params) -> Callable:
    """``fn -> fn`` under activation checkpointing (``model.py:45-52``).

    Policy ``"none"`` (or ``cfg.remat`` off) keeps every activation;
    ``"dots"`` keeps the matmul outputs and recomputes the rest; any other
    policy (``"full"``) keeps only each layer body's inputs and recomputes
    the body in the backward pass.  As ``jax.checkpoint`` acts only under
    differentiation, this applies only while autograd records the forward
    (grad enabled and the parameters requiring grad): serving is
    unchanged.  Each layer is one checkpointed body (the reference's
    hybrid and VLM models checkpoint a whole group; the values are the
    same)."""
    if (not cfg.remat or cfg.remat_policy == "none"
            or not torch.is_grad_enabled()
            or not params["embed"].requires_grad):
        return lambda fn: fn
    kw: Dict[str, Any] = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(_DOTS))
    return lambda fn: functools.partial(checkpoint, fn, **kw)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

#: each family's keys of stacked (per-layer or per-group) parameters
FAMILY_KEYS = {"dense": ("layers",), "moe": ("layers",), "ssm": ("layers",),
               "hybrid": ("groups",), "vlm": ("groups", "cross"),
               "encdec": ("enc_layers", "dec_layers")}


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


def _init_cross_layer(pb: ParamBuilder, cfg: ModelConfig) -> Params:
    """A VLM's cross-attention layer: tanh-gated attention (its ``gate``
    starts at zero) and an MLP (``model.py:71-78``)."""
    return {
        "attn_norm": L.init_norm(pb, cfg),
        "attn": L.init_attention(pb, cfg, cross=True),
        "mlp_norm": L.init_norm(pb, cfg),
        "mlp": L.init_mlp(pb, cfg),
    }


def _init_dec_layer(pb: ParamBuilder, cfg: ModelConfig) -> Params:
    """A Whisper decoder layer: self-attention, ungated cross-attention
    over the encoder's output and the MLP (``model.py:139-148``)."""
    return {**_init_dense_layer(pb, cfg),
            "cross_norm": L.init_norm(pb, cfg),
            "cross": L.init_attention(pb, cfg)}


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
    ``shared`` the ONE attention/MLP block applied after every group.  A
    VLM's ``groups`` are ``n_layers // cross_attn_every`` lists of
    ``cross_attn_every`` dense layers, ``cross`` one gated cross layer per
    group; an enc-dec model has ``enc_pos``, ``enc_layers``, ``enc_norm``
    and ``dec_layers``.  ``pos`` is the learned position table.
    """
    if cfg.family not in FAMILY_KEYS:
        raise ValueError(f"unknown family {cfg.family}")
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
    if cfg.pos_emb == "learned":
        p["pos"] = pb.param((cfg.max_seq, cfg.d_model), scale=0.02)
    fam = cfg.family
    if fam in ("dense", "moe"):
        p["layers"] = [_init_dense_layer(pb, cfg)
                       for _ in range(cfg.n_layers)]
    elif fam == "ssm":
        p["layers"] = [_init_mamba_layer(pb, cfg)
                       for _ in range(cfg.n_layers)]
    elif fam == "hybrid":
        p["groups"] = [[_init_mamba_layer(pb, cfg)
                        for _ in range(cfg.attn_every)]
                       for _ in range(n_groups(cfg))]
        p["shared"] = _init_dense_layer(pb, cfg)
    elif fam == "vlm":
        ng = n_groups(cfg)
        p["groups"] = [[_init_dense_layer(pb, cfg)
                        for _ in range(cfg.cross_attn_every)]
                       for _ in range(ng)]
        p["cross"] = [_init_cross_layer(pb, cfg) for _ in range(ng)]
    else:                                                   # encdec
        p["enc_pos"] = pb.param((cfg.n_frames, cfg.d_model), scale=0.02)
        p["enc_layers"] = [_init_dense_layer(pb, cfg)
                           for _ in range(cfg.n_enc_layers)]
        p["enc_norm"] = L.init_norm(pb, cfg)
        p["dec_layers"] = [_init_dec_layer(pb, cfg)
                           for _ in range(cfg.n_layers)]
    return p


def n_groups(cfg: ModelConfig) -> int:
    """A hybrid model's number of groups of ``attn_every`` Mamba layers
    (= shared-block uses), or a VLM's of ``cross_attn_every`` self layers
    (= cross layers)."""
    every = cfg.attn_every if cfg.family == "hybrid" else cfg.cross_attn_every
    ng = cfg.n_layers // every
    if ng * every != cfg.n_layers:
        raise ValueError(f"group size {every} does not divide n_layers "
                         f"{cfg.n_layers}")
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


def _cross_attention(p, h: Tensor, mem: Tensor, cfg: ModelConfig,
                     q_pos: Tensor, mem_pos: Tensor) -> Tensor:
    """Attention of ``h`` over a memory: no RoPE, no causal mask, and
    tanh-gated when ``p`` has a ``gate`` (the VLM's)."""
    return L.attention(p, h, cfg, q_pos=q_pos, ctx=mem, kv_pos=mem_pos,
                       causal=False, rope=False, block_kv=cfg.attn_block_kv)


def _cross_block(p, x: Tensor, mem: Tensor, cfg: ModelConfig, q_pos: Tensor,
                 mem_pos: Tensor) -> Tensor:
    """A VLM's cross layer: gated cross-attention, then its MLP
    (``model.py:194-203``)."""
    h = L.apply_norm(p["attn_norm"], x, cfg)
    x = x + _cross_attention(p["attn"], h, mem, cfg, q_pos, mem_pos)
    if "mlp" in p:
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["mlp_norm"], x, cfg),
                            cfg)
    return x


def _dec_block(p, x: Tensor, mem: Tensor, cfg: ModelConfig, q_pos: Tensor,
               mem_pos: Tensor):
    """A Whisper decoder layer (``model.py:310-334``): causal
    self-attention without RoPE, cross-attention over the encoder's
    output, the MLP.  Returns the output and the self-attention's (K, V).

    Prefill and forward both attend through ``attention_core``, which
    honours a sliding window.  The reference's prefill form
    (``collect_kv``) calls ``blocked_attention`` with no window instead, so
    there a model given a window prefills other K/V than its forward
    computes (ROADMAP.md, faults of the reference); without a window,
    whisper's own setting, the two are the same computation."""
    h = L.apply_norm(p["attn_norm"], x, cfg)
    q, k, v = L._qkv(p["attn"], h, h, cfg, q_pos, q_pos, False)
    o = L.attention_core(q, k, v, q_pos, q_pos, cfg, causal=True,
                         block_kv=cfg.attn_block_kv)
    x = x + L.out_proj(o, p["attn"]["wo"])
    h = L.apply_norm(p["cross_norm"], x, cfg)
    x = x + _cross_attention(p["cross"], h, mem, cfg, q_pos, mem_pos)
    h = L.apply_norm(p["mlp_norm"], x, cfg)
    return x + L.apply_mlp(p["mlp"], h, cfg), (k, v)


def _positions(b: int, s: int, device) -> Tensor:
    """(B, S) int32 positions 0 .. S-1."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def embed_tokens(p, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    """Token embeddings in the model dtype, plus the learned position
    table's first S rows where the config has one."""
    x = F.embedding(tokens, p["embed"]).to(cfg.torch_dtype)
    if cfg.pos_emb == "learned":
        x = x + p["pos"][:tokens.shape[1]][None].to(x.dtype)
    return x


def unembed(p, cfg: ModelConfig, x: Tensor) -> Tensor:
    """Final norm and the vocabulary projection; float32 logits.

    The reference asks its einsum for a float32 result from inputs in the
    model dtype; here both operands are widened first, which gives the same
    exact products and float32 sums (a bf16 matmul would round the logits).
    """
    x = L.apply_norm(p["final_norm"], x, cfg)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return torch.matmul(x.float(), w.to(x.dtype).float())


def _stack_kv(kvs) -> tuple:
    """Per-layer (K, V) pairs -> (K, V), each stacked on a leading axis."""
    return tuple(torch.stack(t) for t in zip(*kvs))


def forward(params: Params, cfg: ModelConfig, tokens: Tensor,
            memory: Optional[Tensor] = None, collect_kv: bool = False):
    """tokens (B, S) -> (logits (B, S, V) float32, aux, kv).

    ``memory``: an enc-dec model's frame embeddings (B, n_frames, D), a
    VLM's patch embeddings (B, n_img_tokens, D) — the stub front ends'
    output — cast to the model dtype; unused by the other families.
    ``aux`` is the MoE layers' summed aux loss (0.0 without MoE layers).
    ``kv`` (the prefill cache) when ``collect_kv``, else None: a dense,
    MoE or VLM model's ``{"self": (K, V)}``, each (L,B,S,Kh,Dh), the
    layers in order (a VLM's group-major); an enc-dec model's adds
    ``"memory"``, the encoder's output (B, F, D); an SSM model's
    ``{"states": {"ssm": (L,B,h,p,n), "conv": (L,B,K-1,ch)}}``, the Mamba
    layers in order (a hybrid model's group-major, group x attn_every +
    layer); a hybrid model adds ``"shared": (K, V)``, each (G,B,S,Kh,Dh),
    one per application of the shared block.
    """
    fam = cfg.family
    if fam in ("vlm", "encdec") and memory is None:
        raise ValueError(f"family {fam!r} requires a memory")
    x = embed_tokens(params, cfg, tokens)
    b, s = tokens.shape
    q_pos = _positions(b, s, tokens.device)
    remat = _remat(cfg, params)
    dense_block = remat(_dense_block)
    states, kvs, aux = [], [], 0.0
    kv: Optional[Dict[str, Any]] = None
    if fam in ("dense", "moe", "vlm"):                  # model.py:243-303
        if fam == "vlm":
            mem = memory.to(x.dtype)
            i_pos = _positions(b, mem.shape[1], mem.device)
            groups = list(zip(params["cross"], params["groups"]))
        else:
            groups = [(None, params["layers"])]
        cross_block = remat(_cross_block)
        for cp, gp in groups:
            if cp is not None:
                x = cross_block(cp, x, mem, cfg, q_pos, i_pos)
            for pl in gp:
                x, a, lkv = dense_block(pl, x, cfg, q_pos)
                aux = aux + a
                if collect_kv:
                    kvs.append(lkv)
        if collect_kv:
            kv = {"self": _stack_kv(kvs)}
        return unembed(params, cfg, x), aux, kv
    if fam == "encdec":                                 # model.py:305-340
        mem = encode(params, cfg, memory)
        m_pos = _positions(b, mem.shape[1], mem.device)
        dec_block = remat(_dec_block)
        for pl in params["dec_layers"]:
            x, lkv = dec_block(pl, x, mem, cfg, q_pos, m_pos)
            if collect_kv:
                kvs.append(lkv)
        if collect_kv:
            kv = {"self": _stack_kv(kvs), "memory": mem}
        return unembed(params, cfg, x), aux, kv
    if fam == "ssm":
        groups, shared = [params["layers"]], None
    else:                                                   # hybrid
        groups, shared = params["groups"], params["shared"]
    mamba_block = remat(_mamba_block)
    for gp in groups:
        for pl in gp:
            x, st = mamba_block(pl, x, cfg, collect_state=collect_kv)
            states.append(st)
        if shared is not None:
            x, a, lkv = dense_block(shared, x, cfg, q_pos)
            aux = aux + a
            if collect_kv:
                kvs.append(lkv)
    logits = unembed(params, cfg, x)
    if collect_kv:
        kv = {"states": {k: torch.stack([st[k] for st in states])
                         for k in ("ssm", "conv")}}
        if shared is not None:
            kv["shared"] = _stack_kv(kvs)
    return logits, aux, kv


def encode(params: Params, cfg: ModelConfig, frames: Tensor) -> Tensor:
    """Whisper's encoder over stubbed frame embeddings (B, n_frames, D):
    the learned ``enc_pos`` added, then bidirectional attention (no RoPE)
    and the MLP in each layer, then ``enc_norm`` (``model.py:347-367``)."""
    dt = cfg.torch_dtype
    x = frames.to(dt) + params["enc_pos"][None].to(dt)
    pos = _positions(x.shape[0], x.shape[1], x.device)
    enc_block = _remat(cfg, params)(_enc_block)
    for pl in params["enc_layers"]:
        x = enc_block(pl, x, cfg, pos)
    return L.apply_norm(params["enc_norm"], x, cfg)


def _enc_block(p, x: Tensor, cfg: ModelConfig, pos: Tensor) -> Tensor:
    """A Whisper encoder layer: bidirectional attention without RoPE, then
    the MLP."""
    h = L.apply_norm(p["attn_norm"], x, cfg)
    x = x + L.attention(p["attn"], h, cfg, q_pos=pos, causal=False,
                        rope=False, block_kv=cfg.attn_block_kv)
    return x + L.apply_mlp(p["mlp"], L.apply_norm(p["mlp_norm"], x, cfg),
                           cfg)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def lm_loss(params: Params, cfg: ModelConfig, tokens: Tensor,
            memory: Optional[Tensor] = None, aux_weight: float = 0.01):
    """Next-token cross-entropy over the float32 logits of ``tokens`` (B,
    S+1), plus ``aux_weight`` times the MoE aux loss (``model.py:370-380``).

    Returns ``(loss, {"nll": nll, "aux": aux})``, all float32 0-d tensors
    (``aux`` is 0 without MoE layers).  Under autograd each layer body is
    rematerialised as ``cfg.remat`` / ``cfg.remat_policy`` say."""
    logits, aux, _ = forward(params, cfg, tokens[:, :-1], memory=memory)
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (logz - gold).mean()
    aux = torch.as_tensor(aux, dtype=torch.float32, device=logits.device)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}
