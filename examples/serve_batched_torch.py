"""Batched serving on the PyTorch/CUDA port: prefill a batch of prompts,
then decode position-aligned batches with ring KV caches — the counterpart
of ``examples/serve_batched.py``.

Runs three families to show the cache taxonomy:
  qwen3   (dense)  full-attention ring cache
  mamba2  (ssm)    O(1) state, no KV at all (its causal conv1d runs the
                   hand-written CUDA kernel on the card)
  mixtral (moe)    sliding-window ring (bounded long-context decode)

    PYTHONPATH=src python examples/serve_batched_torch.py              # card
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.nn import count_params, tree_leaves
from repro_torch.serving import engine as E

ARCHS = ("qwen3-1.7b", "mamba2-2.7b", "mixtral-8x22b")


def run(arch: str, device, batch=4, prompt_len=24, new_tokens=16,
        use_kernels: bool = True):
    """Generate ``new_tokens`` for a batch of prompts of ``arch``'s smoke
    config; returns ``(tokens (batch, new_tokens), prompt, params, cfg)``."""
    cfg = get_config(arch, smoke=True).scaled(use_kernels=use_kernels)
    params = M.init_params(cfg, 0, device=device)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, prompt_len)), dtype=torch.int32, device=device)
    cache_len = prompt_len + new_tokens

    t0 = time.perf_counter()
    toks, cc = E.generate(params, cfg, prompt, n_new=new_tokens,
                          cache_len=cache_len)
    if toks.device.type == "cuda":
        torch.cuda.synchronize(toks.device)
    dt = time.perf_counter() - t0
    cache_mb = sum(x.numel() * x.element_size()
                   for x in tree_leaves(cc)) / 1e6
    print(f"{arch:22s} family={cfg.family:7s} "
          f"params={count_params(params):>10,} "
          f"cache={cache_mb:7.2f}MB  "
          f"{batch}x{new_tokens} tokens in {dt:5.2f}s  "
          f"sample={toks[0, :6].tolist()}")
    return toks, prompt, params, cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {arch: run(arch, device)[0] for arch in ARCHS}
    print("batched serving OK")
    return out


if __name__ == "__main__":
    main()
