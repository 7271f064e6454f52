"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Note: the assignment line reads "MoE 40e top-8 — 32 experts top-8"; we take
the explicit shape spec (40 experts, top-8). d_ff=512 is the per-expert FFN.

``config()`` and ``smoke()`` copy ``repro/configs/granite_moe_3b_a800m.py``
field for field.
"""
from repro_torch.configs.base import ModelConfig

ARCH = "granite-moe-3b-a800m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49155,
        n_experts=40, top_k=8, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=256,
        n_experts=8, top_k=2, moe_group=64, tie_embeddings=True,
        capacity_factor=8.0,            # drop-free: decode==forward exactly
        max_seq=128, remat=False, dtype="float32",
    )
