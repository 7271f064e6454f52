"""Public wrapper of the depthwise causal conv1d kernel.

On a CUDA tensor :func:`conv1d_causal` launches the kernel or raises; it
runs the plain torch version only for a tensor that lies on the CPU.
Unlike the reference (``repro/kernels/conv1d/ops.py:18-21``) it pads
nothing: the kernel masks the causal history and the ragged edges itself,
and reads ``x`` through its strides, so the model's column slice of the
input projection is never copied.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES
from repro_torch.kernels.conv1d.kernel import MAX_TAPS, conv1d_causal_launch
from repro_torch.kernels.conv1d.ref import conv1d_causal_plain


def conv1d_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, T, D); w (K, D) -> (B, T, D) contiguous, in ``x.dtype``.

    ``w`` is cast to ``x.dtype`` (as the reference casts it); the taps sum
    in float32.  ``x`` may be any view with a unit channel stride.
    """
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(f"need x (B, T, D) and w (K, D), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[1] != x.shape[2] or w.shape[0] < 1:
        raise ValueError(f"w {tuple(w.shape)} does not match D={x.shape[2]}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not in {tuple(DTYPE_CODES)}")
    if w.device != x.device:
        raise ValueError("x and w lie on different devices")
    if x.shape[2] > 1 and x.stride(2) != 1:
        raise ValueError("x needs a unit channel stride")
    w = w.to(x.dtype).contiguous()
    if x.device.type == "cpu":
        return conv1d_causal_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if w.shape[0] > MAX_TAPS:
        raise ValueError(f"the kernel takes at most {MAX_TAPS} taps, got "
                         f"{w.shape[0]}")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    conv1d_causal_launch(x, w, y)
    conv1d_causal.launches += 1
    return y


conv1d_causal.launches = 0    # type: ignore[attr-defined]
