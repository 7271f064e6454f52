"""Serving: prefill and single-token decode steps for all families.

The counterpart of ``repro/serving/engine.py``.  The reference's
``lax.scan`` over stacked layers and over decode steps are Python loops
here; eager decoding launches a few dozen small kernels per layer and
step (CUDA graphs are later work).  The enc-dec and VLM families take a
``memory`` (frame or patch embeddings) at prefill; its cross-attention
K/V is computed once there and kept in the cache.

Batched decoding is position-aligned (one scalar ``pos`` per cache); the
continuous-batching driver (``serving/lm_driver.py``) packs requests into
these aligned batches.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, gather_params
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.serving import cache as C

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# shared decode sub-blocks
# ---------------------------------------------------------------------------

def _embed_one(p, cfg: ModelConfig, token: Tensor, pos: Tensor) -> Tensor:
    """(B, 1) tokens at position ``pos`` -> (B, 1, D); a learned position
    table's row ``min(pos, max_seq - 1)``, read on the device
    (``engine.py:32-39``)."""
    p = gather_params({k: p[k] for k in ("embed", "pos") if k in p})
    x = F.embedding(token, p["embed"]).to(cfg.torch_dtype)
    if cfg.pos_emb == "learned":
        row = torch.clamp(pos, max=cfg.max_seq - 1).reshape(1).long()
        x = x + p["pos"].index_select(0, row)[None].to(x.dtype)
    return x


def _attn_decode(pl, x: Tensor, cfg: ModelConfig, kc: Tensor, vc: Tensor,
                 pos: Tensor, kv_pos: Tensor, slot: Tensor, *,
                 rope: bool = True):
    """One-token self-attention against a ring cache.  Returns (y, kc, vc),
    the caches new tensors with the token written at ``slot``."""
    pl = gather_params({k: pl[k] for k in ("attn_norm", "attn")})
    b = x.shape[0]
    h = L.apply_norm(pl["attn_norm"], x, cfg)
    qp = pos.reshape(1, 1).expand(b, 1)
    q, k, v = L._qkv(pl["attn"], h, h, cfg, qp, qp, rope)
    kc = C.write_token(kc, k, slot)
    vc = C.write_token(vc, v, slot)
    kvp = kv_pos[None].expand(b, -1)
    o = L.decode_attention(q, kc, vc, qp, kvp, window=cfg.sliding_window)
    return x + L.out_proj(o, pl["attn"]["wo"]), kc, vc


def _ffn_decode(pl, x: Tensor, cfg: ModelConfig) -> Tensor:
    """The MLP or MoE of one token (``engine.py:55-61``)."""
    pl = gather_params({k: pl[k] for k in ("mlp_norm", "mlp", "moe")
                        if k in pl})
    h = L.apply_norm(pl["mlp_norm"], x, cfg)
    if "moe" in pl:
        y, _ = L.apply_moe(pl["moe"], h, cfg)
    else:
        y = L.apply_mlp(pl["mlp"], h, cfg)
    return x + y


def _cross_attn_decode(pa, h: Tensor, cfg: ModelConfig, kc: Tensor,
                       vc: Tensor, *, q_norm: bool = True) -> Tensor:
    """One token's attention over a memory's cached K/V (B, T, Kh, Dh),
    every slot valid, no causal mask; tanh-gated when ``pa`` has a
    ``gate``.  ``q_norm``: the query takes the qk-norm where the config
    has one (the VLM's path does, the enc-dec's does not)."""
    pa = gather_params(pa)
    b, t = h.shape[0], kc.shape[1]
    q = L.project("bsd,dhk->bshk", h, pa["wq"].to(h.dtype))
    if q_norm and cfg.qk_norm:
        q = L.rms_head_norm(pa["q_norm"], q, cfg.norm_eps)
    qp = torch.zeros((b, 1), dtype=torch.int32, device=h.device)
    kvp = torch.arange(t, dtype=torch.int32, device=h.device).expand(b, t)
    o = L.decode_attention(q, kc, vc, qp, kvp, window=None, causal=False)
    y = L.out_proj(o, pa["wo"])
    if "gate" in pa:
        y = torch.tanh(pa["gate"].to(y.dtype)) * y
    return y


def _cross_decode(pl, x: Tensor, cfg: ModelConfig, kc: Tensor,
                  vc: Tensor) -> Tensor:
    """A VLM cross layer for one token (``engine.py:64-81``)."""
    pl = gather_params(pl)
    h = L.apply_norm(pl["attn_norm"], x, cfg)
    x = x + _cross_attn_decode(pl["attn"], h, cfg, kc, vc)
    if "mlp" in pl:
        x = x + L.apply_mlp(pl["mlp"], L.apply_norm(pl["mlp_norm"], x, cfg),
                            cfg)
    return x


def _mamba_decode(pl, x: Tensor, st, cfg: ModelConfig):
    pl = gather_params(pl)
    h = L.apply_norm(pl["norm"], x, cfg)
    y, st = S.apply_mamba_decode(pl["mamba"], h, st, cfg)
    return x + y, st


def _mamba_layers(layers, x: Tensor, cache, first: int, cfg: ModelConfig):
    """Decode through consecutive Mamba layers whose states sit at
    ``first``, ``first + 1``, ... of the cache's stacked states."""
    states = []
    for i, pl in enumerate(layers, first):
        x, st = _mamba_decode(
            pl, x, {"ssm": cache["ssm"][i], "conv": cache["conv"][i]}, cfg)
        states.append(st)
    return x, states


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def decode_step(params, cfg: ModelConfig, cache: Dict[str, Any],
                token: Tensor) -> Tuple[Tensor, Dict[str, Any]]:
    """token (B, 1) int -> (logits (B, 1, V) float32, new cache).

    The new cache is new tensors; ``cache`` is left as it was (the token's
    K/V goes into a copy of each ring).  The ring slot is ``pos % ring``,
    and ``kv_pos[slot] = pos`` before attending, computed on the device.
    A VLM or enc-dec cache's ``cross`` K/V is read, not written.
    """
    pos = cache["pos"]
    x = constrain(_embed_one(params, cfg, token, pos),
                  ("batch", None, "embed"))                    # (B,1,D)
    fam = cfg.family
    new = dict(cache)
    states = None
    if fam == "ssm":
        x, states = _mamba_layers(params["layers"], x, cache, 0, cfg)
    else:
        slot = torch.remainder(pos, cache["kv_pos"].shape[0]).reshape(1)
        kv_pos = C.index_copy(cache["kv_pos"], 0, slot.long(), pos.reshape(1))
        new["kv_pos"] = kv_pos
        ks, vs = [], []

        def self_attn(pl, x, i, k, v, rope=True):
            x, kc, vc = _attn_decode(pl, x, cfg, k[i], v[i], pos, kv_pos,
                                     slot, rope=rope)
            ks.append(kc)
            vs.append(vc)
            return x
        if fam in ("dense", "moe"):                      # engine.py:111-119
            for i, pl in enumerate(params["layers"]):
                x = self_attn(pl, x, i, cache["k"], cache["v"])
                x = constrain(_ffn_decode(pl, x, cfg),
                              ("batch", None, "embed"))
        elif fam == "vlm":                               # engine.py:157-181
            every, cross = cfg.cross_attn_every, cache["cross"]
            for g, (cp, gp) in enumerate(zip(params["cross"],
                                             params["groups"])):
                x = _cross_decode(cp, x, cfg, cross["k"][g], cross["v"][g])
                for j, pl in enumerate(gp):
                    x = self_attn(pl, x, g * every + j, cache["k"],
                                  cache["v"])
                    x = _ffn_decode(pl, x, cfg)
        elif fam == "encdec":                            # engine.py:183-205
            cross = cache["cross"]
            for i, pl in enumerate(params["dec_layers"]):
                x = self_attn(pl, x, i, cache["k"], cache["v"], rope=False)
                h = L.apply_norm(pl["cross_norm"], x, cfg)
                x = x + _cross_attn_decode(pl["cross"], h, cfg,
                                           cross["k"][i], cross["v"][i],
                                           q_norm=False)
                x = _ffn_decode(pl, x, cfg)
        else:                                                    # hybrid
            shared, every = params["shared"], cfg.attn_every
            states = []
            sk, sv = cache["shared"]["k"], cache["shared"]["v"]
            for g, gp in enumerate(params["groups"]):
                x, st = _mamba_layers(gp, x, cache, g * every, cfg)
                states += st
                x = self_attn(shared, x, g, sk, sv)
                x = _ffn_decode(shared, x, cfg)
        kv = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if fam == "hybrid":
            new["shared"] = kv
        else:
            new.update(kv)
    logits = M.unembed(params, cfg, x)
    if states is not None:
        new.update({k: torch.stack([st[k] for st in states])
                    for k in ("ssm", "conv")})
    new["pos"] = pos + 1
    return logits, new


def _cross_kv(attn_ps, mem: Tensor, cfg: ModelConfig) -> Dict[str, Tensor]:
    """The cross-attention K/V of a memory (B, T, D) under each of the
    attention parameter dicts ``attn_ps`` (one per cross layer):
    ``{"k", "v"}`` (N, B, T, Kh, Dh), one batched product over the stacked
    weights (``engine.py:218-227``)."""
    attn_ps = [gather_params({k: pa[k] for k in ("wk", "wv", "k_norm")
                              if k in pa}) for pa in attn_ps]
    out = {}
    for name in ("k", "v"):
        w = torch.stack([pa[f"w{name}"] for pa in attn_ps]).to(mem.dtype)
        out[name] = L.project("btd,ndhk->nbthk", mem, w)
    if cfg.qk_norm:
        scale = torch.stack([pa["k_norm"] for pa in attn_ps])
        out["k"] = L.rms_head_norm(scale[:, None, None, None], out["k"],
                                   cfg.norm_eps)
    return out


def prefill(params, cfg: ModelConfig, tokens: Tensor, cache_len: int,
            memory: Optional[Tensor] = None):
    """tokens (B, S) -> (logits (B, S, V), cache ready for decode at pos=S).

    The cache has :func:`cache.init_cache`'s layout, filled from the
    forward's K/V packed into rings (dense, MoE, VLM, enc-dec: every
    self-attention layer's; hybrid: the shared block's), its final SSM
    states (ssm, hybrid) and the cross-attention K/V of ``memory`` (VLM:
    the patch embeddings; enc-dec: the encoder's output over the frames).
    """
    s = tokens.shape[1]
    fam = cfg.family
    logits, _, kv = M.forward(params, cfg, tokens, memory=memory,
                              collect_kv=True)
    cc = {"pos": torch.full((), s, dtype=torch.int32, device=tokens.device)}
    if fam != "ssm":
        ring = C.ring_len(cfg, cache_len)
        cc["kv_pos"] = C.ring_positions(s, ring, device=tokens.device)
    if fam in ("dense", "moe", "vlm", "encdec"):         # engine.py:242-245
        k, v = kv["self"]
        cc["k"] = C.ring_pack(k.to(cfg.torch_dtype), ring)
        cc["v"] = C.ring_pack(v.to(cfg.torch_dtype), ring)
    if fam in ("ssm", "hybrid"):
        cc["ssm"] = kv["states"]["ssm"]
        cc["conv"] = kv["states"]["conv"].to(cfg.torch_dtype)
    if fam == "hybrid":
        k, v = kv["shared"]
        cc["shared"] = {"k": C.ring_pack(k.to(cfg.torch_dtype), ring),
                        "v": C.ring_pack(v.to(cfg.torch_dtype), ring)}
    if fam == "vlm":
        cc["cross"] = _cross_kv([cp["attn"] for cp in params["cross"]],
                                memory.to(cfg.torch_dtype), cfg)
    if fam == "encdec":
        cc["cross"] = _cross_kv([pl["cross"] for pl in params["dec_layers"]],
                                kv["memory"], cfg)
    return logits, cc


def _next_token(logits: Tensor, greedy: bool,
                generator: Optional[torch.Generator]) -> Tensor:
    """(B, V) float32 logits -> (B, 1) int32: argmax, or a sample."""
    if greedy:
        return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def generate(params, cfg: ModelConfig, prompt: Tensor, n_new: int,
             cache_len: int, memory: Optional[Tensor] = None,
             greedy: bool = True,
             generator: Optional[torch.Generator] = None):
    """Autoregressive generation: prefill + ``n_new`` greedy/sampled steps.

    Returns ``(tokens (B, n_new) int32, cache)``: the token after the
    prompt, then the next ``n_new - 1``; the cache has run ``n_new`` decode
    steps, as the reference's does.  ``memory`` as in :func:`prefill`.
    Sampling draws from ``generator`` (a ``torch.Generator`` on the
    prompt's device; seed 0 when None).
    """
    if not greedy and generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    logits, cc = prefill(params, cfg, prompt, cache_len, memory=memory)
    tok = _next_token(logits[:, -1], greedy, generator)
    out = [tok]
    for _ in range(n_new):
        lg, cc = decode_step(params, cfg, cc, out[-1])
        out.append(_next_token(lg[:, -1], greedy, generator))
    return torch.cat(out[:n_new], dim=1), cc
