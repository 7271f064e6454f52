"""Decode-state (KV / SSM) caches for all six families.

The counterpart of ``repro/serving/cache.py``.  A dense or MoE cache
holds every layer's K/V ring, ``k``/``v`` (L, B, ring, Kh, Dh).  An SSM
cache is O(1) in the sequence length: per layer a (B, H, P, N) float32
state and the last K-1 raw conv inputs, stacked over layers as in the
reference, plus the scalar position.  A hybrid cache adds the shared
attention block's K/V, one ring per application, (G, B, ring, Kh, Dh).
A VLM or enc-dec cache adds ``cross``: the K/V of the memory, computed
once at prefill, one per cross layer — (G, B, n_img_tokens, Kh, Dh) or
(L, B, n_frames, Kh, Dh).

KV caches are RING buffers of length ``ring``: the cache length, or the
decode/sliding window when that is shorter.  Position p lives in slot
``p % ring``, and ``kv_pos`` (ring,) records which absolute position
occupies each slot (-1 = empty); it drives the attention mask, so window
and causal semantics survive wrap-around.  Batched decoding is
position-aligned (one scalar ``pos`` per cache).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import Device, resolve_device
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.model import n_groups

Cache = Dict[str, Any]
Tensor = torch.Tensor


def ring_len(cfg: ModelConfig, cache_len: int) -> int:
    w = cfg.decode_window or cfg.sliding_window
    return min(w, cache_len) if w else cache_len


def _kv(cfg: ModelConfig, n: int, batch: int, ring: int, device) -> Cache:
    shape = (n, batch, ring, cfg.n_kv_heads, cfg.d_head)
    return {k: torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
            for k in ("k", "v")}


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

    ``cache_len`` bounds the sequence; the SSM states do not depend on it,
    and a ring holds ``ring_len(cfg, cache_len)`` slots.
    """
    device = resolve_device(device)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    fam = cfg.family
    if fam == "ssm":
        return {"pos": pos, **_ssm_states(cfg, cfg.n_layers, batch, device)}
    ring = ring_len(cfg, cache_len)
    base = {"pos": pos,
            "kv_pos": torch.full((ring,), -1, dtype=torch.int32,
                                 device=device)}
    if fam in ("dense", "moe"):                          # cache.py:56-57
        return {**base, **_kv(cfg, cfg.n_layers, batch, ring, device)}
    if fam == "hybrid":
        return {**base, **_ssm_states(cfg, cfg.n_layers, batch, device),
                "shared": _kv(cfg, n_groups(cfg), batch, ring, device)}
    if fam == "vlm":                                     # cache.py:65-73
        return {**base, **_kv(cfg, cfg.n_layers, batch, ring, device),
                "cross": _kv(cfg, n_groups(cfg), batch, cfg.n_img_tokens,
                             device)}
    if fam == "encdec":
        return {**base, **_kv(cfg, cfg.n_layers, batch, ring, device),
                "cross": _kv(cfg, cfg.n_layers, batch, cfg.n_frames,
                             device)}
    raise ValueError(fam)


# ---------------------------------------------------------------------------
# prefill -> cache construction, and the decode write
# ---------------------------------------------------------------------------

def _whole(x, dim: int) -> tuple:
    """DTensor ``x``'s placements with dim ``dim`` whole (replicated where
    it was split)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in x.placements)


def _shardwise(fn, x, dim: int, *args):
    """``fn(x, *args)`` for a DTensor ``x`` whose dim ``dim`` ``fn`` needs
    whole: run on this device's shard, the result placed as the shard
    was.  DTensor has no rule for ``index_copy`` in torch 2.11, and
    mis-plans ``pad`` there."""
    from repro_torch.distributed.sharding import from_local, to_local
    mesh, pl = x.device_mesh, _whole(x, dim)
    return from_local(fn(to_local(x, mesh, pl, "cache layout"), *args),
                      mesh, pl)


def ring_pack(k_full: Tensor, ring: int) -> Tensor:
    """(N, B, S, ...) full-sequence K/V -> (N, B, ring, ...) ring buffer.

    Keeps the last ``ring`` positions, each at slot p % ring.
    """
    if is_dtensor(k_full):
        return _shardwise(ring_pack, k_full, 2, ring)
    s = k_full.shape[2]
    if s <= ring:
        return F.pad(k_full, (0, 0) * (k_full.dim() - 3) + (0, ring - s))
    return torch.roll(k_full[:, :, s - ring:], (s - ring) % ring, dims=2)


def ring_positions(s: int, ring: int, device: Device = None) -> Tensor:
    """kv_pos (ring,) int32 after prefilling positions [0, s), on
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    if s <= ring:
        slots = torch.arange(ring, dtype=torch.int32, device=device)
        return torch.where(slots < s, slots, -1)
    pos = torch.arange(s - ring, s, dtype=torch.int32, device=device)
    return torch.roll(pos, (s - ring) % ring)


def index_copy(t: Tensor, dim: int, index: Tensor, src: Tensor) -> Tensor:
    """``t.index_copy(dim, index, src)``; on a DTensor ``t``, shard by
    shard: ``src`` laid out as ``t``, ``index`` the same on every device,
    ``dim`` whole."""
    if not is_dtensor(t):
        return t.index_copy(dim, index, src)
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import to_local
    mesh = t.device_mesh
    idx = to_local(index, mesh, (Replicate(),) * mesh.ndim, "cache index")
    local = to_local(src, mesh, _whole(t, dim), "cache write")
    return _shardwise(lambda x: x.index_copy(dim, idx, local), t, dim)


def write_token(kc: Tensor, k_new: Tensor, slot: Tensor) -> Tensor:
    """A copy of ``kc`` (B, ring, ...) with one token's K/V ``k_new``
    (B, 1, ...) at ``slot`` (an integer tensor of one element, on the
    cache's device: no host sync).  ``kc`` is left as it was."""
    return index_copy(kc, 1, slot.reshape(1).long(), k_new.to(kc.dtype))
