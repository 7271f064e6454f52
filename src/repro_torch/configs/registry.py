"""Architecture registry: ``--arch <id>`` -> ModelConfig (full or smoke).

Lists only the architectures whose family the port runs; the others are
still queued in ROADMAP.md (Queue 1, the LM sidecar).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(
            f"arch {arch!r} is not ported to repro_torch yet (ported: "
            f"{ARCHS}); the other families are queued in ROADMAP.md, "
            f"Queue 1")
    mod = importlib.import_module(_MODULES[arch])
    return mod.smoke() if smoke else mod.config()
