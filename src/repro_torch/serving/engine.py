"""Serving: prefill and single-token decode steps.

The counterpart of ``repro/serving/engine.py`` for the families the port
runs so far (``ssm``).  The reference's ``lax.scan`` over stacked layers
and over decode steps are Python loops here; eager decoding launches a few
dozen small kernels per layer and step (CUDA graphs are later work).

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

Tensor = torch.Tensor


def decode_step(params, cfg: ModelConfig, cache: Dict[str, Any],
                token: Tensor) -> Tuple[Tensor, Dict[str, Any]]:
    """token (B, 1) int -> (logits (B, 1, V) float32, new cache).

    The new cache is new tensors; ``cache`` is left as it was.
    """
    M.check_ported(cfg)
    x = M.embed_tokens(params, cfg, token)                       # (B,1,D)
    states = []
    for i, pl in enumerate(params["layers"]):
        h = L.apply_norm(pl["norm"], x, cfg)
        y, st = S.apply_mamba_decode(
            pl["mamba"], h, {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
            cfg)
        x = x + y
        states.append(st)
    logits = M.unembed(params, cfg, x)
    new = {k: torch.stack([st[k] for st in states]) for k in ("ssm", "conv")}
    return logits, {**cache, **new, "pos": cache["pos"] + 1}


def prefill(params, cfg: ModelConfig, tokens: Tensor, cache_len: int):
    """tokens (B, S) -> (logits (B, S, V), cache ready for decode at pos=S)."""
    s = tokens.shape[1]
    logits, _, kv = M.forward(params, cfg, tokens, collect_kv=True)
    # the layout of C.init_cache, filled from the forward's final states
    cc = {"pos": torch.full((), s, dtype=torch.int32, device=tokens.device),
          "ssm": kv["states"]["ssm"],
          "conv": kv["states"]["conv"].to(cfg.torch_dtype)}
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
