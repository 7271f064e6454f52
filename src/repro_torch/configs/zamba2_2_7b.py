"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + weight-SHARED attention
blocks applied every 6 layers (9 applications of one block).
[arXiv:2411.15242; hf]

The Mamba2 layers run the depthwise causal conv1d through the hand-written
CUDA kernel (``repro_torch/kernels/conv1d``) when ``use_kernels`` is on, as
mamba2-2.7b does.  As in the reference: one shared transformer block
instead of the released model's two alternating ones, and no LoRA adapters
on it.
"""
from repro_torch.configs.base import ModelConfig

ARCH = "zamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_width=4,
        attn_every=6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, conv_width=4,
        ssm_chunk=16, attn_every=2,
        max_seq=128, remat=False, dtype="float32",
    )
