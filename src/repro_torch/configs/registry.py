"""Architecture registry: ``--arch <id>`` -> ModelConfig (full or smoke).

Lists the architectures whose family the port runs: ``ssm``, ``hybrid``,
``dense`` and ``moe``, eight of the reference's ten
(``repro/configs/registry.py:13-24``).  The enc-dec ``whisper-large-v3``
and the VLM ``llama-3.2-vision-11b`` are still queued in ROADMAP.md
(Queue 1, the LM sidecar).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(
            f"arch {arch!r} is not ported to repro_torch yet (ported: "
            f"{ARCHS}); the enc-dec (whisper-large-v3) and VLM "
            f"(llama-3.2-vision-11b) families are queued in ROADMAP.md, "
            f"Queue 1")
    mod = importlib.import_module(_MODULES[arch])
    return mod.smoke() if smoke else mod.config()
