"""Serving: prefill and single-token decode steps.

The counterpart of ``repro/serving/engine.py`` for the families the port
runs so far (``dense``, ``moe``, ``ssm``, ``hybrid``).  The reference's
``lax.scan`` over stacked layers and over decode steps are Python loops
here; eager decoding launches a few dozen small kernels per layer and
step (CUDA graphs are later work).

Batched decoding is position-aligned (one scalar ``pos`` per cache); the
continuous-batching driver (``serving/lm_driver.py``) packs requests into
these aligned batches.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.serving import cache as C

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# shared decode sub-blocks
# ---------------------------------------------------------------------------

def _attn_decode(pl, x: Tensor, cfg: ModelConfig, kc: Tensor, vc: Tensor,
                 pos: Tensor, kv_pos: Tensor, slot: Tensor):
    """One-token self-attention against a ring cache.  Returns (y, kc, vc),
    the caches new tensors with the token written at ``slot``."""
    b = x.shape[0]
    h = L.apply_norm(pl["attn_norm"], x, cfg)
    qp = pos.reshape(1, 1).expand(b, 1)
    q, k, v = L._qkv(pl["attn"], h, h, cfg, qp, qp, True)
    kc = C.write_token(kc, k, slot)
    vc = C.write_token(vc, v, slot)
    kvp = kv_pos[None].expand(b, -1)
    o = L.decode_attention(q, kc, vc, qp, kvp, window=cfg.sliding_window)
    return x + L.out_proj(o, pl["attn"]["wo"]), kc, vc


def _ffn_decode(pl, x: Tensor, cfg: ModelConfig) -> Tensor:
    """The MLP or MoE of one token (``engine.py:55-61``)."""
    h = L.apply_norm(pl["mlp_norm"], x, cfg)
    if "moe" in pl:
        y, _ = L.apply_moe(pl["moe"], h, cfg)
    else:
        y = L.apply_mlp(pl["mlp"], h, cfg)
    return x + y


def _mamba_decode(pl, x: Tensor, st, cfg: ModelConfig):
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
    """
    M.check_ported(cfg)
    pos = cache["pos"]
    x = M.embed_tokens(params, cfg, token)                       # (B,1,D)
    new = dict(cache)
    states = None
    if cfg.family == "ssm":
        x, states = _mamba_layers(params["layers"], x, cache, 0, cfg)
    else:
        slot = torch.remainder(pos, cache["kv_pos"].shape[0]).reshape(1)
        kv_pos = cache["kv_pos"].index_copy(0, slot.long(), pos.reshape(1))
        new["kv_pos"] = kv_pos
        ks, vs = [], []
        if cfg.family in ("dense", "moe"):               # engine.py:111-119
            for i, pl in enumerate(params["layers"]):
                x, kc, vc = _attn_decode(pl, x, cfg, cache["k"][i],
                                         cache["v"][i], pos, kv_pos, slot)
                x = _ffn_decode(pl, x, cfg)
                ks.append(kc)
                vs.append(vc)
            new["k"], new["v"] = torch.stack(ks), torch.stack(vs)
        else:                                                    # hybrid
            shared, every = params["shared"], cfg.attn_every
            states = []
            for g, gp in enumerate(params["groups"]):
                x, st = _mamba_layers(gp, x, cache, g * every, cfg)
                states += st
                x, kc, vc = _attn_decode(shared, x, cfg,
                                         cache["shared"]["k"][g],
                                         cache["shared"]["v"][g], pos,
                                         kv_pos, slot)
                x = _ffn_decode(shared, x, cfg)
                ks.append(kc)
                vs.append(vc)
            new["shared"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    logits = M.unembed(params, cfg, x)
    if states is not None:
        new.update({k: torch.stack([st[k] for st in states])
                    for k in ("ssm", "conv")})
    new["pos"] = pos + 1
    return logits, new


def prefill(params, cfg: ModelConfig, tokens: Tensor, cache_len: int):
    """tokens (B, S) -> (logits (B, S, V), cache ready for decode at pos=S).

    The cache has :func:`cache.init_cache`'s layout, filled from the
    forward's K/V packed into rings (dense, MoE: every layer's; hybrid: the
    shared block's) and its final SSM states (ssm, hybrid).
    """
    s = tokens.shape[1]
    logits, _, kv = M.forward(params, cfg, tokens, collect_kv=True)
    cc = {"pos": torch.full((), s, dtype=torch.int32, device=tokens.device)}
    if cfg.family != "ssm":
        ring = C.ring_len(cfg, cache_len)
        cc["kv_pos"] = C.ring_positions(s, ring, device=tokens.device)
    if cfg.family in ("dense", "moe"):                   # engine.py:242-245
        k, v = kv["self"]
        cc["k"] = C.ring_pack(k.to(cfg.torch_dtype), ring)
        cc["v"] = C.ring_pack(v.to(cfg.torch_dtype), ring)
        return logits, cc
    cc["ssm"] = kv["states"]["ssm"]
    cc["conv"] = kv["states"]["conv"].to(cfg.torch_dtype)
    if cfg.family == "hybrid":
        k, v = kv["shared"]
        cc["shared"] = {"k": C.ring_pack(k.to(cfg.torch_dtype), ring),
                        "v": C.ring_pack(v.to(cfg.torch_dtype), ring)}
    return logits, cc


def _next_token(logits: Tensor, greedy: bool,
                generator: Optional[torch.Generator]) -> Tensor:
    """(B, V) float32 logits -> (B, 1) int32: argmax, or a sample."""
    if greedy:
        return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def generate(params, cfg: ModelConfig, prompt: Tensor, n_new: int,
             cache_len: int, greedy: bool = True,
             generator: Optional[torch.Generator] = None):
    """Autoregressive generation: prefill + ``n_new`` greedy/sampled steps.

    Returns ``(tokens (B, n_new) int32, cache)``: the token after the
    prompt, then the next ``n_new - 1``; the cache has run ``n_new`` decode
    steps, as the reference's does.  Sampling draws from ``generator`` (a
    ``torch.Generator`` on the prompt's device; seed 0 when None).
    """
    if not greedy and generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    logits, cc = prefill(params, cfg, prompt, cache_len)
    tok = _next_token(logits[:, -1], greedy, generator)
    out = [tok]
    for _ in range(n_new):
        lg, cc = decode_step(params, cfg, cc, out[-1])
        out.append(_next_token(lg[:, -1], greedy, generator))
    return torch.cat(out[:n_new], dim=1), cc
