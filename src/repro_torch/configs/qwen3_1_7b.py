"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — qk-norm, GQA, tied embeddings. [hf:Qwen/Qwen3-8B; hf]

``config()`` and ``smoke()`` copy ``repro/configs/qwen3_1_7b.py``
field for field.
"""
from repro_torch.configs.base import ModelConfig

ARCH = "qwen3-1.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=6144, vocab=151936,
        qk_norm=True, rope_theta=1e6, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256,
        qk_norm=True, tie_embeddings=True,
        max_seq=128, remat=False, dtype="float32",
    )
