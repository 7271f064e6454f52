"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block.

The counterpart of ``repro/models/ssm.py``.  Prefill runs the chunked SSD
algorithm: within-chunk "attention form" (C B^T masked by cumulative
decays) plus an inter-chunk recurrent state pass, here a Python loop over
chunks.  Decoding is the O(1) recurrence on a (H, P, N) state.  The einsums
are plain torch in float32, as the reference computes them outside any
kernel.

The depthwise causal conv (width 4) over (x, B, C) is a per-channel 1-D
stencil: with ``cfg.use_kernels`` it runs through the hand-written CUDA
kernel (``repro_torch/kernels/conv1d``), which reads the strided column
slice of the input projection in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import Device, resolve_device
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels.conv1d.ops import conv1d_causal
from repro_torch.kernels.conv1d.ref import conv1d_causal_ref
from repro_torch.models.nn import ParamBuilder

Tensor = torch.Tensor

#: log-decay clip of the reference (``exp`` of at most 60 below zero)
_CLIP = 60.0


def init_mamba(pb: ParamBuilder, cfg: ModelConfig):
    d, di = cfg.d_model, cfg.d_inner
    h, n = cfg.ssm_heads, cfg.ssm_state
    conv_ch = di + 2 * n                   # x, B, C share the conv
    return {
        "in_proj": pb.param((d, 2 * di + 2 * n + h), axes=("embed", "mlp")),
        "conv_w": pb.param((cfg.conv_width, conv_ch), axes=("conv", "mlp")),
        "conv_b": pb.param((conv_ch,), axes=("mlp",), init="zeros"),
        "a_log": pb.param((h,), axes=("heads",), init="zeros"),
        "dt_bias": pb.param((h,), axes=("heads",), init="zeros"),
        "D": pb.param((h,), axes=("heads",), init="ones"),
        "norm": pb.param((di,), axes=("mlp",), init="ones"),
        "out_proj": pb.param((di, d), axes=("mlp", "embed")),
    }


def _split(cfg: ModelConfig, proj: Tensor):
    """(z, xbc, dt) column views of the input projection (no copies)."""
    di, n = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    return z, xbc, dt


def _conv(p, xbc: Tensor, cfg: ModelConfig) -> Tensor:
    w = p["conv_w"].to(xbc.dtype)
    conv = conv1d_causal if cfg.use_kernels else conv1d_causal_ref
    y = _conv_shards(conv, xbc, w) if is_dtensor(xbc) else conv(xbc, w)
    return F.silu(y + p["conv_b"].to(xbc.dtype))


def _conv_shards(conv, x, w):
    """``conv(x, w)`` of a DTensor x (B, T, ch) shard by shard: T whole,
    each device's channels with their taps (torch 2.11 cannot plan the
    redistribution of the conv's padding)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import from_local, to_local
    mesh = x.device_mesh
    xpl = tuple(p if isinstance(p, Shard) and p.dim != 1 else Replicate()
                for p in x.placements)
    wpl = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 2
                else Replicate() for p in xpl)
    y = conv(to_local(x, mesh, xpl, "conv input", xpl),
             to_local(w, mesh, wpl, "conv taps", xpl))
    return from_local(y, mesh, xpl)


def _gated_norm(y: Tensor, z: Tensor, scale: Tensor, eps: float) -> Tensor:
    """y * silu(z), then RMS norm over d_inner (statistics in float32)."""
    y = y * F.silu(z)
    yf = y.float()
    return (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + eps)
            * scale.float()).to(y.dtype)


def ssd_chunked(x: Tensor, dt: Tensor, a_log: Tensor, B: Tensor, C: Tensor,
                D: Tensor, chunk: int):
    """Chunked SSD scan.

    x (b,t,h,p); dt (b,t,h) (post-softplus); a_log (h); B,C (b,t,n); D (h).
    Returns (y (b,t,h,p) float32, final_state (b,h,p,n) float32).

    Padded tail positions carry dt = 0 (padded after the softplus), so they
    neither decay nor feed the state: the returned final_state is exact,
    which the prefill -> decode handoff relies on.
    """
    if is_dtensor(x):
        return _ssd_shards(x, dt, a_log, B, C, D, chunk)
    b, t, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, t)
    nc = -(-t // q)
    pad = nc * q - t
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    xc = x.reshape(b, nc, q, h, p).float()
    dtc = dt.reshape(b, nc, q, h).float()
    Bc = B.reshape(b, nc, q, n).float()
    Cc = C.reshape(b, nc, q, n).float()

    la = -torch.exp(a_log.float()) * dtc                  # (b,nc,q,h) log-decay
    cum = torch.cumsum(la, dim=2)

    # ---- intra-chunk (attention form) ----
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)          # (b,nc,q,q)
    li = cum[:, :, :, None, :]                            # i index
    lj = cum[:, :, None, :, :]                            # j index
    decay = torch.exp(torch.clamp(li - lj, -_CLIP, 0.0))  # (b,nc,q,q,h)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    att = cb[..., None] * decay * dtc[:, :, None, :, :]   # weight by dt_j
    att = torch.where(mask[None, None, :, :, None], att, 0.0)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xc)

    # ---- chunk states ----
    last = cum[:, :, -1:, :]                              # (b,nc,1,h)
    w = torch.exp(torch.clamp(last - cum, min=-_CLIP)) * dtc  # (b,nc,q,h)
    S = torch.einsum("bcjh,bcjn,bcjhp->bchpn", w, Bc, xc)  # (b,nc,h,p,n)
    A_chunk = torch.exp(torch.clamp(last[:, :, 0, :], -_CLIP, 0.0))  # (b,nc,h)

    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):                                   # the reference's scan
        prev.append(state)
        state = state * A_chunk[:, c, :, None, None] + S[:, c]
    states_prev = torch.stack(prev, dim=1)                # (b,nc,h,p,n)

    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Cc, states_prev,
                           torch.exp(torch.clamp(cum, -_CLIP, 0.0)))
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :t]
    y = y + D.float()[None, None, :, None] * xc.reshape(b, nc * q, h, p)[:, :t]
    return y, state


def _ssd_shards(x, dt, a_log, B, C, D, chunk: int):
    """:func:`ssd_chunked` on DTensors, shard by shard: the scan is
    independent per batch row and per head, so each device scans its own
    rows and, where the rules split d_inner (logical ``mlp``, of which the
    heads are groups), its own heads (DTensor would replicate the chunk
    tensors, and in torch 2.11 has no rule for the ``flip`` in
    ``cumsum``'s backward)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import (act_placements, from_local,
                                                  keep_dims, split_by,
                                                  to_local)
    mesh = x.device_mesh
    xpl = act_placements(("batch", None, "mlp"), tuple(x.shape[:3]), mesh)
    rows = keep_dims(xpl, (0,))
    hd = split_by(xpl, 2)
    per_head = tuple(Shard(0) if i in hd else Replicate()
                     for i in range(mesh.ndim))
    state_pl = tuple(Shard(1) if i in hd else q for i, q in enumerate(rows))
    y, state = ssd_chunked(to_local(x, mesh, xpl, "ssd x", xpl),
                           to_local(dt, mesh, xpl, "ssd dt", xpl),
                           to_local(a_log, mesh, per_head, "ssd a", xpl),
                           to_local(B, mesh, rows, "ssd B", xpl),
                           to_local(C, mesh, rows, "ssd C", xpl),
                           to_local(D, mesh, per_head, "ssd D", xpl), chunk)
    return from_local(y, mesh, xpl), from_local(state, mesh, state_pl)


def apply_mamba(p, x: Tensor, cfg: ModelConfig, return_state: bool = False):
    """Training/prefill forward. x (B,T,D) -> (B,T,D) [, decode state]."""
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc_raw, dt = _split(cfg, proj)
    xbc = _conv(p, xbc_raw, cfg)
    xs = xbc[..., :di]
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    xh = xs.reshape(*xs.shape[:-1], h, hd)
    y, final = ssd_chunked(xh, dt, p["a_log"], B, C, p["D"], cfg.ssm_chunk)
    y = _gated_norm(y.reshape(xs.shape).to(x.dtype), z, p["norm"],
                    cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    if not return_state:
        return out
    # conv rolling buffer = last (K-1) *raw* conv inputs, left-zero padded
    kb = cfg.conv_width - 1
    t = xbc_raw.shape[1]
    # a copy: a view would keep the whole input projection alive
    buf = xbc_raw[:, -kb:].clone() if t >= kb else \
        F.pad(xbc_raw, (0, 0, kb - t, 0))
    return out, {"ssm": final, "conv": buf}


def mamba_init_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device: Device = None):
    """An empty decode state of one layer on ``device`` (``None``: the
    card, raising without one)."""
    device = resolve_device(device)
    h, hd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, h, hd, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner + 2 * n),
                            dtype=dtype, device=device),
    }


def apply_mamba_decode(p, x: Tensor, state, cfg: ModelConfig):
    """Single-token step. x (B,1,D); state dict -> (y (B,1,D), state)."""
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = _split(cfg, proj)
    # conv over the rolling buffer
    buf = torch.cat([state["conv"], xbc], dim=1)           # (B,K,ch)
    w = p["conv_w"].to(x.dtype)
    conv_out = torch.einsum("bkc,kc->bc", buf, w)[:, None, :]
    xbc = F.silu(conv_out + p["conv_b"].to(x.dtype))
    xs = xbc[..., :di]
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"].float())[:, 0]      # (B,h)
    a = torch.exp(-torch.exp(p["a_log"].float()) * dt)            # (B,h)
    xh = xs.reshape(-1, h, hd).float()                            # (B,h,hd)
    inc = dt[:, :, None, None] * xh[..., None] * \
        B[:, 0].float()[:, None, None, :]                         # (B,h,hd,n)
    s = state["ssm"] * a[:, :, None, None] + inc
    y = torch.einsum("bhpn,bn->bhp", s, C[:, 0].float())
    y = y + p["D"].float()[None, :, None] * xh
    y = _gated_norm(y.reshape(-1, 1, di).to(x.dtype), z, p["norm"],
                    cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), {"ssm": s, "conv": buf[:, 1:]}
