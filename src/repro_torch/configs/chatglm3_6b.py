"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — 2d-RoPE (rotates half the head dim), GQA.
[arXiv:2406.12793; hf]

``config()`` and ``smoke()`` copy ``repro/configs/chatglm3_6b.py``
field for field.
"""
from repro_torch.configs.base import ModelConfig

ARCH = "chatglm3-6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=65024,
        rope_fraction=0.5,                  # ChatGLM 2d-RoPE
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256,
        rope_fraction=0.5,
        max_seq=128, remat=False, dtype="float32",
    )
