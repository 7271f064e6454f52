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
from repro_torch.models.nn import ParamBuilder

Tensor = torch.Tensor

#: the position that marks a padded KV slot in ``blocked_attention``
_PAD_POS = torch.iinfo(torch.int32).max

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(pb: ParamBuilder, cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    p = {"scale": pb.param((d,), init="ones")}
    if cfg.norm == "ln":
        p["bias"] = pb.param((d,), init="zeros")
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
        "wq": pb.param((d, h, dh)),
        "wk": pb.param((d, kh, dh)),
        "wv": pb.param((d, kh, dh)),
        "wo": pb.param((h, dh, d)),
    }
    if cfg.qk_norm:
        p["q_norm"] = pb.param((dh,), init="ones")
        p["k_norm"] = pb.param((dh,), init="ones")
    if cross:
        p["gate"] = pb.param((), init="zeros")       # tanh-gated xattn
    return p


def _qkv(p, x: Tensor, ctx: Tensor, cfg: ModelConfig, q_pos: Tensor,
         kv_pos: Tensor, rope: bool):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("btd,dhk->bthk", ctx, p["wk"].to(x.dtype))
    v = torch.einsum("btd,dhk->bthk", ctx, p["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if rope and cfg.pos_emb == "rope":
        q = apply_rope(q, q_pos, cfg)
        k = apply_rope(k, kv_pos, cfg)
    return q, k, v


def out_proj(o: Tensor, wo: Tensor) -> Tensor:
    """(B, S, H, Dh) attention output -> (B, S, D)."""
    return torch.einsum("bshk,hkd->bsd", o, wo.to(o.dtype))


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
    slots.
    """
    b, _, h, d = q.shape
    kh = k_cache.shape[2]
    sc = _scores(_heads_first(q * (1.0 / math.sqrt(d)), kh), k_cache, 1)
    kp = kv_pos[:, None, None, None, :]
    qp = q_pos[:, None, :, None, None]
    msk = kp >= 0
    if causal:
        msk = msk & (kp <= qp)
    if window is not None:
        msk = msk & (kp > qp - window)
    p = torch.softmax(torch.where(msk, sc, -math.inf), dim=-1)
    return _heads_last(_pv(p.to(v_cache.dtype), v_cache), q.dtype)


def attention_core(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                   kv_pos: Tensor, cfg: ModelConfig, *, causal: bool,
                   block_kv: int = 1024) -> Tensor:
    """Dispatch: the banded sliding-window path (when enabled) or the
    blocked/flash one."""
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
        return {"w1": pb.param((d, f)), "w3": pb.param((d, f)),
                "w2": pb.param((f, d))}
    return {"w1": pb.param((d, f)), "w2": pb.param((f, d))}


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
    return {"router": pb.param((d, e)), "w1": pb.param((e, d, f)),
            "w3": pb.param((e, d, f)), "w2": pb.param((e, f, d))}


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
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    nt = b * s
    grp = min(cfg.moe_group, nt)
    n_grp = -(-nt // grp)
    xf = x.reshape(nt, d)
    if n_grp * grp != nt:         # pad tokens fill the tail dispatch group
        xf = F.pad(xf, (0, 0, 0, n_grp * grp - nt))
    xt = xf.reshape(n_grp, grp, d)
    r = moe_route(p, xt, cfg)
    cap = r.cap
    n_slots = n_grp * e * cap
    grp_base = torch.arange(n_grp, device=x.device)[:, None, None] * e
    dest = torch.where(r.keep, (grp_base + r.idx) * cap + r.slot, n_slots)
    dest = dest.reshape(-1)                                    # (g*n*k,)
    xe = x.new_zeros((n_slots + 1, d))
    xe.index_copy_(0, dest, xt[:, :, None].expand(-1, -1, k, -1)
                   .reshape(-1, d))
    xe = xe[:n_slots].view(n_grp, e, cap, d).transpose(0, 1)
    xe = xe.reshape(e, n_grp * cap, d)
    h = F.silu(torch.bmm(xe, p["w1"].to(x.dtype)).float())
    h = (h * torch.bmm(xe, p["w3"].to(x.dtype)).float()).to(x.dtype)
    ye = torch.bmm(h, p["w2"].to(x.dtype))                     # (e, g*cap, d)
    ye = ye.view(e, n_grp, cap, d).transpose(0, 1).reshape(n_slots, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    ddt = torch.bfloat16 if cfg.moe_dispatch_dtype == "bfloat16" \
        else torch.float32
    wts = (r.gate * r.keep).to(ddt).to(x.dtype).float()        # (g,n,k)
    y = (wts[..., None] * ye[dest].view(n_grp, grp, k, d).float()).sum(2)

    # Switch-style load-balancing aux loss
    me = r.probs.mean(dim=1)                                   # (g,e)
    ce = r.sel.sum(2).float().mean(dim=1)                      # (g,e)
    aux = (me * ce).sum(-1).mean() * e
    return y.reshape(n_grp * grp, d)[:nt].reshape(b, s, d).to(x.dtype), aux
