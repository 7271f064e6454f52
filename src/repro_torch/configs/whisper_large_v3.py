"""whisper-large-v3 [audio/encdec] — 32L(enc)+32L(dec) d_model=1280 20H
(kv=20, MHA) d_ff=5120 vocab=51866 — encoder-decoder, learned positions,
LayerNorm + GELU. [arXiv:2212.04356]

The convolutional front end is a stub, as in the reference: the model takes
precomputed frame embeddings (B, 1500, d_model) as its ``memory``.
``max_seq=32768`` extends the decoder's learned-position table (the
released model stops at 448).  ``config()`` and ``smoke()`` copy
``repro/configs/whisper_large_v3.py`` field for field.
"""
from repro_torch.configs.base import ModelConfig

ARCH = "whisper-large-v3"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="encdec",
        n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20,
        n_kv_heads=20, d_ff=5120, vocab=51866,
        n_frames=1500, pos_emb="learned", act="gelu", norm="ln",
        max_seq=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        n_frames=16, pos_emb="learned", act="gelu", norm="ln",
        max_seq=128, remat=False, dtype="float32",
    )
