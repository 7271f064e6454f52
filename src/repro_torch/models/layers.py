"""Transformer components: norms, RoPE, GQA attention (blocked/flash,
banded sliding-window, decode), the MLP and capacity-based MoE.

The counterpart of ``repro/models/layers.py``, in plain torch ops that
mirror the reference's formulation.  Conventions as there:
activations in ``cfg.dtype``, softmax and norm statistics in float32;
q/k/v laid out (B, S, H, Dh); GQA groups G = n_heads // n_kv_heads, head
``kh * G + g`` attending KV head ``kh``.

The reference asks its score and PV einsums for a float32 result from
operands in the model dtype: exact products, float32 sums.  Here both
operands are widened to float32 first, which computes the same (a bf16
``torch.matmul`` would round the result to bf16).  Internally the
attention functions keep KV heads ahead of the sequence, (B, Kh, S, G, ·),
so each product is one batched matmul.

The MoE (``layers.py:325-395``) keeps the reference's routing, capacity
and sums, but dispatches and combines by index instead of through its
(group, token, choice, expert, slot) one-hot: the same (token, choice)
pairs are kept and each expert slot receives the same token.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, is_dtensor
from repro_torch.models.nn import ParamBuilder

Tensor = torch.Tensor

#: the position that marks a padded KV slot in ``blocked_attention``
_PAD_POS = torch.iinfo(torch.int32).max

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(pb: ParamBuilder, cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    p = {"scale": pb.param((d,), axes=("embed",), init="ones")}
    if cfg.norm == "ln":
        p["bias"] = pb.param((d,), axes=("embed",), init="zeros")
    return p


def apply_norm(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    xf = x.float()
    if cfg.norm == "ln":
        xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    if cfg.norm == "ln":
        y = y + p["bias"].float()
    return y.to(x.dtype)


def rms_head_norm(scale: Tensor, x: Tensor, eps: float) -> Tensor:
    """qk-norm (Qwen3): RMS over the head dim."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, d_rot: int, device) -> Tensor:
    """(d_rot/2,) float32 inverse frequencies, computed in float64 as the
    reference computes them in NumPy (on ``device``: no host copy)."""
    exp = torch.arange(0, d_rot, 2, dtype=torch.float64, device=device) / d_rot
    return (1.0 / (cfg.rope_theta ** exp)).float()


def apply_rope(x: Tensor, pos: Tensor, cfg: ModelConfig) -> Tensor:
    """x (..., S, H, D); pos (..., S) int.  Rotates the first
    ``rope_fraction * D`` lanes in interleaved pairs ``(x[0::2], x[1::2])``
    — not the "rotate-half" layout — with float32 angles, and casts the
    rotated lanes back to ``x.dtype``."""
    d = x.shape[-1]
    d_rot = int(cfg.rope_fraction * d)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    freqs = rope_freqs(cfg, d_rot, x.device)              # (d_rot/2,)
    angles = pos[..., None].float() * freqs               # (..., S, d_rot/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin                              # float32
    o2 = x2 * cos + x1 * sin
    rot = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([rot.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(pb: ParamBuilder, cfg: ModelConfig, cross: bool = False):
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": pb.param((d, h, dh), axes=("embed", "q_heads", "head")),
        "wk": pb.param((d, kh, dh), axes=("embed", "kv_heads", "head")),
        "wv": pb.param((d, kh, dh), axes=("embed", "kv_heads", "head")),
        "wo": pb.param((h, dh, d), axes=("q_heads", "head", "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = pb.param((dh,), axes=("head",), init="ones")
        p["k_norm"] = pb.param((dh,), axes=("head",), init="ones")
    if cross:
        p["gate"] = pb.param((), axes=(), init="zeros")  # tanh-gated xattn
    return p


def project(eq: str, x: Tensor, w: Tensor) -> Tensor:
    """``torch.einsum(eq, x, w)``: activations ``x`` times a weight.

    On DTensors, on local shards, in the weight's layout: on each mesh dim
    the weight splits a dim, ``x`` is split on the same letter where it
    has it (else replicated there) and the output is split on that letter
    (or a partial sum over it when contracted); on the other mesh dims
    ``x`` keeps its batch split (:func:`sharding.batch_placements`).
    DTensor would flatten the weight's head dims into one, which torch
    2.11 refuses when the inner one is split (``head_fallback``)."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distributed.sharding import (batch_placements,
                                                  from_local, to_local)
    ins, out = eq.split("->")
    xl, wl = ins.split(",")
    mesh = (x if is_dtensor(x) else w).device_mesh
    rep = (Replicate(),) * mesh.ndim
    xpl, wpl, opl = [], [], []
    for bp, wp in zip(batch_placements(x) if is_dtensor(x) else rep,
                      w.placements if is_dtensor(w) else rep):
        letter = wl[wp.dim] if isinstance(wp, Shard) else \
            xl[0] if isinstance(bp, Shard) else None
        xpl.append(Shard(xl.index(letter)) if letter and letter in xl
                   else Replicate())
        wpl.append(Shard(wl.index(letter)) if letter and letter in wl
                   else Replicate())
        opl.append(Replicate() if letter is None else
                   Shard(out.index(letter)) if letter in out else Partial())
    opl = tuple(opl)
    y = torch.einsum(eq, to_local(x, mesh, tuple(xpl), "projection input",
                                  opl),
                     to_local(w, mesh, tuple(wpl), "projection weight", opl))
    return from_local(y, mesh, opl)


def _qkv(p, x: Tensor, ctx: Tensor, cfg: ModelConfig, q_pos: Tensor,
         kv_pos: Tensor, rope: bool):
    q = constrain(project("bsd,dhk->bshk", x, p["wq"].to(x.dtype)),
                  ("batch", "seq", "q_heads", "head"), "qkv")
    k = constrain(project("btd,dhk->bthk", ctx, p["wk"].to(x.dtype)),
                  ("batch", "kv_seq", "kv_heads", "head"), "qkv")
    v = constrain(project("btd,dhk->bthk", ctx, p["wv"].to(x.dtype)),
                  ("batch", "kv_seq", "kv_heads", "head"), "qkv")
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if rope and cfg.pos_emb == "rope":
        q = apply_rope(q, q_pos, cfg)
        k = apply_rope(k, kv_pos, cfg)
    return q, k, v


def out_proj(o: Tensor, wo: Tensor) -> Tensor:
    """(B, S, H, Dh) attention output -> (B, S, D)."""
    return project("bshk,hkd->bsd", o, wo.to(o.dtype))


def _heads_first(q: Tensor, kh: int) -> Tensor:
    """q (B, S, H, D) scaled -> (B, Kh, S*G, D) float32."""
    b, s, h, d = q.shape
    return (q.reshape(b, s, kh, h // kh, d).float().permute(0, 2, 1, 3, 4)
            .reshape(b, kh, -1, d))


def _scores(qh: Tensor, kc: Tensor, s: int) -> Tensor:
    """qh (B, Kh, S*G, D) float32, kc (B, T, Kh, D) -> (B, Kh, S, G, T)
    float32."""
    b, kh = qh.shape[:2]
    sc = torch.matmul(qh, kc.float().permute(0, 2, 3, 1))
    return sc.view(b, kh, s, -1, kc.shape[1])


def _pv(p: Tensor, vc: Tensor) -> Tensor:
    """p (B, Kh, S, G, T) in ``vc.dtype``, vc (B, T, Kh, D) ->
    (B, Kh, S, G, D) float32."""
    b, kh, s, g, t = p.shape
    out = torch.matmul(p.float().reshape(b, kh, s * g, t),
                       vc.float().permute(0, 2, 1, 3))
    return out.view(b, kh, s, g, -1)


def _heads_last(o: Tensor, dtype: torch.dtype) -> Tensor:
    """(B, Kh, S, G, D) -> (B, S, H, D) in ``dtype``."""
    b, kh, s, g, d = o.shape
    return o.permute(0, 2, 1, 3, 4).reshape(b, s, kh * g, d).to(dtype)


def blocked_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                      kv_pos: Tensor, *, causal: bool,
                      window: Optional[int], block_kv: int = 1024) -> Tensor:
    """Flash-style attention: a loop over KV blocks with an online softmax.

    q (B,S,H,D); k,v (B,T,Kh,D); positions int32 (B,S) / (B,T).  K/V are
    padded to a multiple of ``block_kv`` with position int32 max (masked);
    all-masked rows keep ``-inf`` maxima safe and ``l`` is floored at 1e-20,
    as in the reference.
    """
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qh = _heads_first(q * scale, kh)

    nblk = -(-t // block_kv)
    t_pad = nblk * block_kv
    if t_pad != t:
        k = F.pad(k, (0, 0, 0, 0, 0, t_pad - t))
        v = F.pad(v, (0, 0, 0, 0, 0, t_pad - t))
        kv_pos = F.pad(kv_pos, (0, t_pad - t), value=_PAD_POS)

    g = h // kh
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, kh, s, g), -math.inf, **f32)
    l = torch.zeros((b, kh, s, g), **f32)
    acc = torch.zeros((b, kh, s, g, d), **f32)
    qp = q_pos[:, None, :, None, None]
    for i in range(nblk):
        blk = slice(i * block_kv, (i + 1) * block_kv)
        kc, vc = k[:, blk], v[:, blk]
        pc = kv_pos[:, None, None, None, blk]                # (B,1,1,1,bk)
        sc = _scores(qh, kc, s)
        msk = pc != _PAD_POS
        if causal:
            msk = msk & (pc <= qp)
        if window is not None:
            msk = msk & (pc > qp - window)
        sc = torch.where(msk, sc, -math.inf)
        m_new = torch.maximum(m, sc.amax(-1))
        # guard all-masked rows
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        pexp = torch.exp(sc - m_safe[..., None])
        pexp = torch.where(msk, pexp, 0.0)
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + pexp.sum(-1)
        acc = acc * corr[..., None] + _pv(pexp.to(vc.dtype), vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return _heads_last(out, q.dtype)


def banded_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                     kv_pos: Tensor, *, window: int,
                     block_q: int = 512) -> Tensor:
    """Sliding-window attention that skips out-of-band KV.

    A query chunk [qs, qs+Bq) under a causal window W sees only
    kv[qs+Bq-L, qs+Bq) with L = Bq + W: one end-aligned slice and one exact
    softmax per chunk.  Requires contiguous positions (prefill
    self-attention).  q (B,S,H,D); k,v (B,T,Kh,D).  Returns (B,S,H,D).
    """
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    L = block_q + window
    nq = -(-s // block_q)
    s_pad = nq * block_q
    if s_pad != s:
        q = F.pad(q, (0, 0, 0, 0, 0, s_pad - s))
        q_pos = F.pad(q_pos, (0, s_pad - s), value=_PAD_POS - 1)
    if t < L:                                   # left-pad so slices exist
        k = F.pad(k, (0, 0, 0, 0, L - t, 0))
        v = F.pad(v, (0, 0, 0, 0, L - t, 0))
        kv_pos = F.pad(kv_pos, (L - t, 0), value=-1)
    qs = q * scale
    outs = []
    for i in range(nq):
        # the end-aligned band, clamped into the (padded) keys
        start = min(max(i * block_q + block_q - L, 0), k.shape[1] - L)
        kc, vc = k[:, start:start + L], v[:, start:start + L]
        pc = kv_pos[:, None, None, None, start:start + L]    # (B,1,1,1,L)
        qp = q_pos[:, None, i * block_q:(i + 1) * block_q, None, None]
        sc = _scores(_heads_first(qs[:, i * block_q:(i + 1) * block_q], kh),
                     kc, block_q)
        msk = (pc <= qp) & (pc > qp - window) & (pc >= 0)
        sc = torch.where(msk, sc, -math.inf)
        mx = sc.amax(-1, keepdim=True)
        mx = torch.where(torch.isinf(mx), 0.0, mx)
        p = torch.where(msk, torch.exp(sc - mx), 0.0)
        l = torch.clamp_min(p.sum(-1, keepdim=True), 1e-20)
        outs.append(_pv((p / l).to(vc.dtype), vc))
    out = _heads_last(torch.cat(outs, dim=2), q.dtype)
    return out[:, :s]


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     q_pos: Tensor, kv_pos: Tensor, *,
                     window: Optional[int], causal: bool = True) -> Tensor:
    """Single-token attention over a cache.  q (B,1,H,D); caches
    (B,T,Kh,D); q_pos (B,1), kv_pos (B,T) with -1 for an empty slot.

    ``causal=False`` (cross-attention over a memory) masks only the empty
    slots.  On DTensors: :func:`_decode_parallel`.
    """
    if is_dtensor(q):
        return _decode_parallel(q, k_cache, v_cache, q_pos, kv_pos,
                                window=window, causal=causal)
    return _decode(q, k_cache, v_cache, q_pos, kv_pos, window, causal,
                   q.shape[-1])


def _decode(q, k_cache, v_cache, q_pos, kv_pos, window, causal, d: int,
            reduce=None) -> Tensor:
    """:func:`decode_attention` of head dim ``d``; ``reduce`` sums the
    (B, Kh, 1, G, T) scores over the devices that split the head dim."""
    kh = k_cache.shape[2]
    sc = _scores(_heads_first(q * (1.0 / math.sqrt(d)), kh), k_cache, 1)
    if reduce is not None:
        sc = reduce(sc)
    kp = kv_pos[:, None, None, None, :]
    qp = q_pos[:, None, :, None, None]
    msk = kp >= 0
    if causal:
        msk = msk & (kp <= qp)
    if window is not None:
        msk = msk & (kp > qp - window)
    p = torch.softmax(torch.where(msk, sc, -math.inf), dim=-1)
    return _heads_last(_pv(p.to(v_cache.dtype), v_cache), q.dtype)


def _layouts(q, k):
    """(mesh, q's, k's, q_pos's and kv_pos's placements) of an attention
    of DTensor q (B, S, H, D) over k (B, T, Kh, D): q as the logical axes
    ``(batch, seq, kv_heads)`` say under the rules — the heads split only
    where the KV heads divide, so each device's query heads attend its own
    KV heads — and k, v the same but whole over T, since a chunk of
    queries attends every key; each position tensor as its tensor's dims
    0 and 1."""
    from repro_torch.distributed.sharding import act_placements, keep_dims
    mesh = q.device_mesh
    qpl = act_placements(("batch", "seq", "kv_heads"),
                         (q.shape[0], q.shape[1], k.shape[2]), mesh)
    kpl = keep_dims(qpl, (0, 2))
    return mesh, qpl, kpl, keep_dims(qpl, (0, 1)), keep_dims(qpl, (0,))


def _heads_parallel(fn, q, k, v, q_pos, kv_pos, *args, **kw):
    """``fn(q, k, v, q_pos, kv_pos, *args, **kw)`` — an attention of q
    (B, S, H, D) over k, v (B, T, Kh, D) — on DTensors: each device
    attends its own batch rows, its own heads where the KV heads are
    split and its own queries where the sequence is (:func:`_layouts`),
    on local tensors (the reference's GSPMD layout of the attention
    einsums; DTensor would gather the heads to flatten them with the
    batch into one matmul batch dim).  Inputs are laid out so with
    :func:`sharding.to_local` (noted when it communicates); plain
    positions are the same on every device."""
    from repro_torch.distributed.sharding import from_local, to_local
    mesh, qpl, kpl, qppl, kppl = _layouts(q, k)
    o = fn(to_local(q, mesh, qpl, "attention q", qpl),
           to_local(k, mesh, kpl, "attention k", qpl),
           to_local(v, mesh, kpl, "attention v", qpl),
           to_local(q_pos, mesh, qppl, "positions"),
           to_local(kv_pos, mesh, kppl, "positions"), *args, **kw)
    return from_local(o, mesh, qpl)


def _decode_parallel(q, k_cache, v_cache, q_pos, kv_pos, *, window, causal):
    """:func:`decode_attention` on DTensors.  Where the rules with
    ``head_fallback`` split the head dim — the layout the reference gives
    a decode cache whose KV heads do not divide the tensor-parallel axis
    — each device holds a slice of every head's dim: its partial scores
    are summed over the mesh dims of that split (B x H x T, far smaller
    than the cache) and it weights its own slice of V.  Otherwise
    :func:`_heads_parallel`."""
    from torch.distributed.tensor import Partial

    from repro_torch.distributed.sharding import (act_placements, from_local,
                                                  keep_dims, split_by,
                                                  to_local)
    mesh = q.device_mesh
    b, s, _, d = q.shape
    dpl = act_placements(("batch", "seq", "kv_heads", "head"),
                         (b, s, k_cache.shape[2], d), mesh,
                         head_fallback=True)
    dims = split_by(dpl, 3)
    if not dims:
        return _heads_parallel(decode_attention, q, k_cache, v_cache, q_pos,
                               kv_pos, window=window, causal=causal)
    rows = keep_dims(dpl, (0,))
    part = tuple(Partial() if i in dims else p for i, p in enumerate(rows))

    def reduce(sc):
        return from_local(sc, mesh, part).redistribute(mesh, rows) \
            .to_local()
    kpl = keep_dims(dpl, (0, 2, 3))
    o = _decode(to_local(q, mesh, dpl, "attention q"),
                to_local(k_cache, mesh, kpl, "attention k"),
                to_local(v_cache, mesh, kpl, "attention v"),
                to_local(q_pos, mesh, keep_dims(dpl, (0, 1)), "positions"),
                to_local(kv_pos, mesh, rows, "positions"), window, causal,
                d, reduce)
    return from_local(o, mesh, dpl)


def attention_core(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                   kv_pos: Tensor, cfg: ModelConfig, *, causal: bool,
                   block_kv: int = 1024) -> Tensor:
    """Dispatch: the banded sliding-window path (when enabled) or the
    blocked/flash one (on DTensors: :func:`_heads_parallel`)."""
    if is_dtensor(q):
        return _heads_parallel(attention_core, q, k, v, q_pos, kv_pos, cfg,
                               causal=causal, block_kv=block_kv)
    window = cfg.sliding_window if causal else None
    if (causal and window and cfg.banded_attention
            and q.shape[1] > 1 and q.shape[1] == k.shape[1]):
        return banded_attention(q, k, v, q_pos, kv_pos, window=window,
                                block_q=cfg.attn_block_q)
    return blocked_attention(q, k, v, q_pos, kv_pos, causal=causal,
                             window=window, block_kv=block_kv)


def attention(p, x: Tensor, cfg: ModelConfig, *, q_pos: Tensor,
              ctx: Optional[Tensor] = None, kv_pos: Optional[Tensor] = None,
              causal: bool = True, rope: bool = True,
              block_kv: int = 1024) -> Tensor:
    """Full (self- or cross-) attention for prefill."""
    ctx_in = x if ctx is None else ctx
    if kv_pos is None:
        kv_pos = q_pos
    q, k, v = _qkv(p, x, ctx_in, cfg, q_pos, kv_pos, rope)
    o = attention_core(q, k, v, q_pos, kv_pos, cfg, causal=causal,
                       block_kv=block_kv)
    y = out_proj(o, p["wo"])
    if "gate" in p:
        y = torch.tanh(p["gate"].to(y.dtype)) * y
    return y


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(pb: ParamBuilder, cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"w1": pb.param((d, f), axes=("embed", "mlp")),
                "w3": pb.param((d, f), axes=("embed", "mlp")),
                "w2": pb.param((f, d), axes=("mlp", "embed"))}
    return {"w1": pb.param((d, f), axes=("embed", "mlp")),
            "w2": pb.param((f, d), axes=("mlp", "embed"))}


def apply_mlp(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    """SwiGLU, or GELU in its tanh form (``jax.nn.gelu``'s default)."""
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w1"].to(x.dtype)) * (x @ p["w3"].to(x.dtype))
    else:
        h = F.gelu(x @ p["w1"].to(x.dtype), approximate="tanh")
    return h @ p["w2"].to(x.dtype)


# ---------------------------------------------------------------------------
# MoE (top-k routing, capacity-based dispatch — GShard/MaxText style)
# ---------------------------------------------------------------------------

def init_moe(pb: ParamBuilder, cfg: ModelConfig):
    """The router (d, E) and E SwiGLU experts (``layers.py:325-333``)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": pb.param((d, e), axes=("embed", "experts")),
            "w1": pb.param((e, d, f), axes=("experts", "embed", "mlp")),
            "w3": pb.param((e, d, f), axes=("experts", "embed", "mlp")),
            "w2": pb.param((e, f, d), axes=("experts", "mlp", "embed"))}


def moe_capacity(cfg: ModelConfig, group: int) -> int:
    """Slots per expert and group: ceil(group * k * cf / E) rounded up to a
    multiple of 8, at least 8 (``layers.py:336-339``)."""
    cap = int(math.ceil(group * cfg.top_k * cfg.capacity_factor
                        / cfg.n_experts))
    return max(8, -(-cap // 8) * 8)


class MoeRoute(NamedTuple):
    """The routing of (g, n) grouped tokens over E experts, k choices each."""
    probs: Tensor       # (g, n, E) float32 router softmax
    idx: Tensor         # (g, n, k) int64 expert of each choice
    gate: Tensor        # (g, n, k) float32 gates, renormalised over k
    slot: Tensor        # (g, n, k) int64 position in the expert's buffer
    keep: Tensor        # (g, n, k) bool: slot < cap (else dropped)
    sel: Tensor         # (g, n, k, E) int64 one-hot of idx
    cap: int


def moe_route(p, xt: Tensor, cfg: ModelConfig) -> MoeRoute:
    """Route ``xt`` (g, n, d) as the reference does (``layers.py:361-374``).

    Router logits in the model dtype, softmax in float32, the top k with
    ties to the lower expert (``jax.lax.top_k``'s order: a stable sort),
    gates renormalised with a 1e-9 floor.  A choice's slot is the running
    count of its expert over the group flattened token-major (n * k + j),
    so earlier tokens win; a choice at slot >= cap is dropped.
    """
    e, k = cfg.n_experts, cfg.top_k
    g, n, _ = xt.shape
    logits = torch.matmul(xt, p["router"].to(xt.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :k], idx[..., :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    sel = F.one_hot(idx, e)                                   # (g,n,k,e)
    # each expert's running count along the innermost axis of (g, e, n*k):
    # scanned along the middle axis of (g, n*k, e), Granite's prefill count
    # took 0.83 ms per layer (NVIDIA H100 80GB HBM3, 700.00 W)
    count = torch.cumsum(sel.reshape(g, n * k, e).transpose(1, 2)
                         .contiguous(), dim=-1)
    slot = torch.gather(count, 1, idx.reshape(g, 1, n * k)) - 1
    slot = slot.reshape(g, n, k)
    cap = moe_capacity(cfg, n)
    return MoeRoute(probs, idx, gate, slot, slot < cap, sel, cap)


def apply_moe(p, x: Tensor, cfg: ModelConfig):
    """x (B, S, D) -> ((B, S, D), the Switch load-balancing aux loss).

    ``layers.py:342-395``: tokens in groups of ``cfg.moe_group`` (the tail
    group padded with zero tokens, which are routed too), each kept choice
    copied into its expert's slot, the SwiGLU experts over every slot
    (empty slots are zeros) with their products in the model dtype, and
    the output the kept choices' expert outputs weighted by their gates,
    summed in float32.  The SwiGLU's silu and product run in float32 and
    round once, as XLA's fused element-wise chain does in the reference's
    bf16.  The gate passes through ``cfg.moe_dispatch_dtype`` and the
    model dtype on its way, as the reference's combine tensor does.
    Dispatch and combine index a flat (g * E * cap + 1, D) buffer whose
    last row takes the dropped choices and reads back as zero.

    On DTensors this is :func:`_moe_expert_parallel`.
    """
    if is_dtensor(x):
        return _moe_expert_parallel(p, x, cfg)
    y, aux = _moe_local(p, x, cfg, 0)
    return y.to(x.dtype), aux


def _moe_local(p, x: Tensor, cfg: ModelConfig, lo: int):
    """:func:`apply_moe` on plain tensors whose ``w1``/``w3``/``w2`` hold
    the experts ``lo .. lo + n`` of the ``router``'s E: every token is
    routed over all E, and only the choices of those experts are
    dispatched and combined.  Returns the float32 output (the sum of
    those choices' terms) and the aux loss."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    ne = p["w1"].shape[0]
    nt = b * s
    grp = min(cfg.moe_group, nt)
    n_grp = -(-nt // grp)
    xf = x.reshape(nt, d)
    if n_grp * grp != nt:         # pad tokens fill the tail dispatch group
        xf = F.pad(xf, (0, 0, 0, n_grp * grp - nt))
    xt = xf.reshape(n_grp, grp, d)
    r = moe_route(p, xt, cfg)
    cap = r.cap
    n_slots = n_grp * ne * cap
    grp_base = torch.arange(n_grp, device=x.device)[:, None, None] * ne
    keep = r.keep if ne == e else r.keep & (r.idx >= lo) & (r.idx < lo + ne)
    dest = torch.where(keep, (grp_base + r.idx - lo) * cap + r.slot, n_slots)
    dest = dest.reshape(-1)                                    # (g*n*k,)
    xe = x.new_zeros((n_slots + 1, d))
    xe.index_copy_(0, dest, xt[:, :, None].expand(-1, -1, k, -1)
                   .reshape(-1, d))
    xe = xe[:n_slots].view(n_grp, ne, cap, d).transpose(0, 1)
    xe = xe.reshape(ne, n_grp * cap, d)
    h = F.silu(torch.bmm(xe, p["w1"].to(x.dtype)).float())
    h = (h * torch.bmm(xe, p["w3"].to(x.dtype)).float()).to(x.dtype)
    ye = torch.bmm(h, p["w2"].to(x.dtype))                    # (ne, g*cap, d)
    ye = ye.view(ne, n_grp, cap, d).transpose(0, 1).reshape(n_slots, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    ddt = torch.bfloat16 if cfg.moe_dispatch_dtype == "bfloat16" \
        else torch.float32
    wts = (r.gate * keep).to(ddt).to(x.dtype).float()         # (g,n,k)
    y = (wts[..., None] * ye[dest].view(n_grp, grp, k, d).float()).sum(2)

    # Switch-style load-balancing aux loss
    me = r.probs.mean(dim=1)                                   # (g,e)
    ce = r.sel.sum(2).float().mean(dim=1)                      # (g,e)
    aux = (me * ce).sum(-1).mean() * e
    return y.reshape(n_grp * grp, d)[:nt].reshape(b, s, d), aux


def _moe_expert_parallel(p, x, cfg: ModelConfig):
    """:func:`apply_moe` on DTensors, in the reference's layout: dispatch
    groups over the batch axes, the experts split as the rules' logical
    ``experts`` axis says where E divides it.

    Each device routes its own tokens (the batch shard, whole over the
    expert split) over all E experts, in dispatch groups of its own tokens
    (the one-device groups where ``moe_group`` divides a shard's tokens),
    runs the experts it holds on the choices routed to them and sums their
    terms; the output is that partial sum over the expert split (reduced
    at the caller's ``constrain``), the aux loss the mean over the batch
    shards.  The
    router and the expert weights are gathered to the devices that use
    them (ZeRO-3) and the tokens to the batch layout;
    :func:`sharding.redistribute` notes each such move."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distributed.sharding import (act_placements, from_local,
                                                  keep_dims, shard_index,
                                                  split_by, to_local)
    mesh = x.device_mesh
    pl = act_placements(("batch", "experts"), (x.shape[0], cfg.n_experts),
                        mesh)
    batch = keep_dims(pl, (0,))
    ep = split_by(pl, 1)
    wpl = tuple(Shard(0) if i in ep else Replicate()
                for i in range(mesh.ndim))
    y_pl = tuple(Partial() if i in ep else q for i, q in enumerate(batch))
    xl = to_local(x, mesh, batch, "moe tokens", y_pl)
    router = to_local(p["router"], mesh, (Replicate(),) * mesh.ndim,
                      "moe router", y_pl)
    w = {n: to_local(p[n], mesh, wpl, "moe experts", y_pl)
         for n in ("w1", "w3", "w2")}
    lo = shard_index(mesh, ep) * w["w1"].shape[0]
    y, aux = _moe_local({"router": router, **w}, xl, cfg, lo)
    # aux is the mean of the batch shards' losses, each computed alike on
    # every device of the expert split: a sum of 1/n-th shares, so that
    # each device's router gradient takes its share of the aux term
    aux_pl = tuple(Replicate() if q.is_replicate() else Partial()
                   for q in y_pl)
    aux = aux / math.prod(mesh.size(i) for i, q in enumerate(aux_pl)
                          if q.is_partial())
    return (from_local(y.to(x.dtype), mesh, y_pl),
            from_local(aux, mesh, aux_pl))
