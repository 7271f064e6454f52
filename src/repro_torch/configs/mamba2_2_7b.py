"""mamba2-2.7b [ssm] — 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060]

The depthwise causal conv1d inside every SSD block is a per-channel 1-D
stencil; with ``use_kernels=True`` it runs through the hand-written CUDA
kernel of ``repro_torch/kernels/conv1d``.
"""
from repro_torch.configs.base import ModelConfig

ARCH = "mamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, conv_width=4,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, conv_width=4,
        ssm_chunk=16, tie_embeddings=True,
        max_seq=128, remat=False, dtype="float32",
    )
