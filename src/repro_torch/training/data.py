"""Synthetic token pipeline — stateless and step-seeded.

The counterpart of ``repro/training/data.py``: ``batch(step)`` is a pure
function of (seed, step), so a restarted job resumes mid-epoch with no
data-loader state in its checkpoint.  :func:`global_batch` is the
reference's NumPy generator, copied, so both packages see byte-identical
batches.  :func:`device_batch` puts the whole batch on one device;
:func:`sharded_batch` makes it a DTensor split over a mesh's batch axes.

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


def sharded_batch(dc: DataConfig, step: int, mesh):
    """``global_batch(dc, step)`` as a DTensor on ``mesh`` (a DeviceMesh),
    its rows split over the batch axes of the active sharding rules
    (``pod``, ``data`` by default) when they divide the batch, replicated
    otherwise (``data.py:51-66``).
    Every rank draws the same global batch from the seed and keeps its own
    rows, so nothing is sent, and any mesh sees the same batch."""
    from repro_torch.distributed.sharding import (NamedSharding, distribute,
                                                  rules_for, spec_for)
    spec = spec_for(("batch",), (dc.global_batch,), rules_for(mesh).acts,
                    mesh)
    full = torch.from_numpy(global_batch(dc, step)).to(
        resolve_device(mesh.device_type))
    return distribute(full, NamedSharding(mesh, spec))


def batch_iterator(dc: DataConfig, device: Device = None,
                   start_step: int = 0):
    """``(step, device_batch(dc, step, device))`` from ``start_step`` on."""
    device = resolve_device(device)
    step = start_step
    while True:
        yield step, device_batch(dc, step, device)
        step += 1
