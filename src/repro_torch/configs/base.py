"""Model configuration schema and the assigned shape cells.

Field for field the schema of the JAX reference (``repro/configs/base.py``),
so a reference config converts through ``dataclasses.asdict`` and
:func:`repro_torch.models.convert.config_from_fields`.  One field is
renamed: ``use_pallas`` (the Pallas kernel in the graph) is ``use_kernels``
here, the hand-written CUDA kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                       # 0 -> d_model // n_heads
    act: str = "swiglu"                   # swiglu | gelu
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_fraction: float = 1.0            # chatglm3 2d-RoPE: 0.5
    pos_emb: str = "rope"                 # rope | learned
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch_dtype: str = "float32"
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (Zamba2): a shared attention block every ``attn_every`` layers
    attn_every: int = 0
    # enc-dec (Whisper)
    n_enc_layers: int = 0
    n_frames: int = 1500
    # VLM (Llama-3.2-vision): gated cross-attn layer every ``cross_attn_every``
    cross_attn_every: int = 0
    n_img_tokens: int = 0
    # numerics / execution
    norm: str = "rms"                     # rms | ln
    moe_group: int = 512                  # tokens per MoE dispatch group
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    use_kernels: bool = False             # hand-written CUDA kernels in the model
    max_seq: int = 8192                   # learned-pos table length (static)
    remat: bool = True                    # activation checkpointing (training)
    remat_policy: str = "full"            # dots | full | none
    attn_block_kv: int = 1024             # flash KV block
    decode_window: Optional[int] = None   # ring-cache override (serving)
    banded_attention: bool = False
    attn_block_q: int = 512               # banded path query chunk

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family {self.family} not in {FAMILIES}")
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:             # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        """The activation and parameter dtype (``dtype`` as a torch dtype)."""
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)

SHAPE_BY_NAME = {c.name: c for c in SHAPE_CELLS}

# long_500k needs sub-quadratic attention: SSM/hybrid families qualify, and
# SWA archs (bounded KV); pure full-attention archs are skipped
LONG_CONTEXT_OK = ("mamba2-2.7b", "zamba2-2.7b", "starcoder2-7b",
                   "mixtral-8x22b")


def cell_applicable(arch: str, cell: ShapeCell, family: str) -> bool:
    if cell.name == "long_500k":
        return arch in LONG_CONTEXT_OK
    return True
