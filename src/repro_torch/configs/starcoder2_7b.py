"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE, sliding-window 4096, LayerNorm + GELU.
[arXiv:2402.19173; hf]

The sliding window bounds the decode ring cache to 4096 slots
(``serving/cache.py`` ``ring_len``); the first config of the port with
LayerNorm and GELU.

``config()`` and ``smoke()`` copy ``repro/configs/starcoder2_7b.py``
field for field.
"""
from repro_torch.configs.base import ModelConfig

ARCH = "starcoder2-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
        d_ff=18432, vocab=49152,
        sliding_window=4096, act="gelu", norm="ln",
        rope_theta=1e5,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256,
        sliding_window=16, act="gelu", norm="ln",
        max_seq=128, remat=False, dtype="float32",
    )
