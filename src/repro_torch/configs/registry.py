"""Architecture registry: ``--arch <id>`` -> ModelConfig (full or smoke),
plus meta-tensor input specs for every (arch x shape-cell) dry-run cell.

Lists the reference's ten architectures (``repro/configs/registry.py:13-24``)
in all six families: ``dense``, ``moe``, ``ssm``, ``hybrid``, ``encdec``
and ``vlm``.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

from repro_torch.configs.base import (SHAPE_CELLS, ModelConfig, ShapeCell,
                                      cell_applicable)

_MODULES: Dict[str, str] = {
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r} (known: {ARCHS})")
    mod = importlib.import_module(_MODULES[arch])
    return mod.smoke() if smoke else mod.config()


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of a cell
    (``registry.py:37-58``):

    train    -> tokens (B, S+1)  (the loss shifts internally) [+ memory]
    prefill  -> tokens (B, S)                                  [+ memory]
    decode   -> token (B, 1) + the cache tree (``init_cache`` on meta)

    Tokens are int64 (the reference's are int32: ``F.embedding`` takes
    int64 indices); the memory stub is (B, n_img_tokens | n_frames,
    d_model) in the model dtype for ``vlm`` / ``encdec``.
    """
    b, s = cell.global_batch, cell.seq_len
    meta = dict(dtype=torch.int64, device="meta")
    if cell.kind == "decode":
        from repro_torch.serving.cache import init_cache
        return {"token": torch.empty((b, 1), **meta),
                "cache": init_cache(cfg, b, s, device="meta")}
    specs = {"tokens": torch.empty((b, s + 1 if cell.kind == "train" else s),
                                   **meta)}
    frames = {"vlm": cfg.n_img_tokens, "encdec": cfg.n_frames}
    if cfg.family in frames:
        specs["memory"] = torch.empty((b, frames[cfg.family], cfg.d_model),
                                      dtype=cfg.torch_dtype, device="meta")
    return specs


def iter_cells(arch: str):
    """Applicable ``(cell, skip_reason)`` pairs for an arch."""
    cfg = get_config(arch)
    for cell in SHAPE_CELLS:
        if cell_applicable(arch, cell, cfg.family):
            yield cell, None
        else:
            yield cell, ("long_500k needs sub-quadratic attention; "
                         "this arch is pure full-attention")
