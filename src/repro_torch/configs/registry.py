"""Architecture registry: ``--arch <id>`` -> ModelConfig (full or smoke).

Lists the reference's ten architectures (``repro/configs/registry.py:13-24``)
in all six families: ``dense``, ``moe``, ``ssm``, ``hybrid``, ``encdec``
and ``vlm``.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

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
