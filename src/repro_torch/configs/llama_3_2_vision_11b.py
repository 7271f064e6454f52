"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, a tanh-gated cross-attention layer before every 5 self
layers (8 in all). [hf:meta-llama/Llama-3.2-11B-Vision]

The vision front end is a stub, as in the reference: the model takes
precomputed patch embeddings (B, n_img_tokens, d_model) as its
``memory``.  ``config()`` and ``smoke()`` copy
``repro/configs/llama_3_2_vision_11b.py`` field for field.
"""
from repro_torch.configs.base import ModelConfig

ARCH = "llama-3.2-vision-11b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256,
        rope_theta=500_000.0,
        cross_attn_every=5, n_img_tokens=1600,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="vlm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256,
        cross_attn_every=2, n_img_tokens=8,
        max_seq=128, remat=False, dtype="float32",
    )
