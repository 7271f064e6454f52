"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (kv=32, i.e. MHA)
d_ff=8192 vocab=32064 — RoPE, SwiGLU. [arXiv:2404.14219; unverified]

``config()`` and ``smoke()`` copy ``repro/configs/phi3_mini_3_8b.py``
field for field.
"""
from repro_torch.configs.base import ModelConfig

ARCH = "phi3-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32064,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        max_seq=128, remat=False, dtype="float32",
    )
