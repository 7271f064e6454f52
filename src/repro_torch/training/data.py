"""Synthetic token pipeline — stateless and step-seeded.

The counterpart of ``repro/training/data.py``: ``batch(step)`` is a pure
function of (seed, step), so a restarted job resumes mid-epoch with no
data-loader state in its checkpoint.  :func:`global_batch` is the
reference's NumPy generator, copied, so both packages see byte-identical
batches.  On one card there is one shard: :func:`device_batch` takes the
place of the reference's ``sharded_batch``.

The generator is a mixture of Zipfian unigrams and short repeated n-grams,
a learnable next-token distribution.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import Device, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram: int = 8          # period of the repeated pattern


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return p / p.sum()


def global_batch(dc: DataConfig, step: int) -> np.ndarray:
    """The full (B, S+1) int32 batch for a step (host-side numpy)."""
    rng = np.random.default_rng(np.uint64(dc.seed * 1_000_003 + step))
    probs = _zipf_probs(dc.vocab, dc.zipf_a)
    b, s = dc.global_batch, dc.seq_len + 1
    base = rng.choice(dc.vocab, size=(b, dc.ngram), p=probs)
    reps = -(-s // dc.ngram)
    tok = np.tile(base, (1, reps))[:, :s]
    # sprinkle noise so the task is not trivially periodic
    noise_mask = rng.random((b, s)) < 0.15
    noise = rng.choice(dc.vocab, size=(b, s), p=probs)
    tok = np.where(noise_mask, noise, tok)
    return tok.astype(np.int32)


def device_batch(dc: DataConfig, step: int,
                 device: Device = None) -> torch.Tensor:
    """``global_batch(dc, step)`` as an int32 tensor on ``device``
    (``None``: the card)."""
    return torch.from_numpy(global_batch(dc, step)).to(
        resolve_device(device))


def batch_iterator(dc: DataConfig, device: Device = None,
                   start_step: int = 0):
    """``(step, device_batch(dc, step, device))`` from ``start_step`` on."""
    device = resolve_device(device)
    step = start_step
    while True:
        yield step, device_batch(dc, step, device)
        step += 1
