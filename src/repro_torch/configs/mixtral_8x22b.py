"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]

The largest assigned config: 140,630,071,296 parameters, 281 GB in
bf16, more than one 80 GB card holds, so on one card it runs cut in
depth (``scaled(n_layers=...)``).  The sliding window (4096) bounds the
decode ring cache.

``config()`` and ``smoke()`` copy ``repro/configs/mixtral_8x22b.py``
field for field.
"""
from repro_torch.configs.base import ModelConfig

ARCH = "mixtral-8x22b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=32768,
        n_experts=8, top_k=2, sliding_window=4096,
        rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=256,
        n_experts=4, top_k=2, moe_group=64, sliding_window=16,
        capacity_factor=8.0,            # drop-free: decode==forward exactly
        max_seq=128, remat=False, dtype="float32",
    )
