"""Plain torch versions of the depthwise causal conv1d.

    y[b, t, d] = sum_k w[k, d] * x[b, t - K + 1 + k, d]   (zero history)

This is the Mamba2 short conv — a radius-(K-1) one-sided 1-D stencil
applied independently per channel.  Two versions, as in the reference:

* :func:`conv1d_causal_ref` is ``repro/kernels/conv1d/ref.py``: it
  accumulates in ``x.dtype``, rounding after every tap.  The model uses it
  when ``use_kernels`` is off, as the reference's ``_conv`` does.
* :func:`conv1d_causal_plain` repeats the kernel's arithmetic
  (``repro/kernels/conv1d/kernel.py:34-38``, ``csrc/conv1d_causal.cu``):
  float32 accumulation, one rounding to ``x.dtype`` at the end.  The
  wrapper runs it for a CPU tensor, and the card checks the kernel against
  it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d_causal_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, T, D); w (K, D) -> (B, T, D), accumulated in ``x.dtype``."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    t = x.shape[1]
    acc = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    for i in range(k):
        acc = acc + w[i][None, None, :] * xp[:, i:i + t, :]
    return acc


def conv1d_causal_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, T, D); w (K, D) -> (B, T, D): float32 sums, ``x.dtype`` out."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    t = x.shape[1]
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        acc = acc + w[i].float()[None, None, :] * xp[:, i:i + t, :].float()
    return acc.to(x.dtype)
