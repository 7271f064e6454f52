"""Serving launcher: continuous-batched generate over the scheduler.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        [--smoke] [--device cpu] --requests 8 --max-batch 4 \\
        --prompt-len 32 --new-tokens 32

``--arch`` is any architecture of ``repro_torch.configs.ARCHS``: the dense
``qwen3-1.7b``, ``phi3-mini-3.8b``, ``starcoder2-7b`` and ``chatglm3-6b``,
the MoE ``granite-moe-3b-a800m`` and ``mixtral-8x22b`` (whose 281 GB in
bf16 no single card holds: on one card, ``--smoke`` only), the SSM
``mamba2-2.7b`` and the hybrid ``zamba2-2.7b``.

The counterpart of ``repro/launch/serve.py``, with the same flags and
printout plus ``--device`` (default: the card; ``cpu`` runs the kernels'
plain versions).  The model runs with ``use_kernels`` on.  Requests are
submitted one prompt at a time — as a front end would deliver them — and
the :class:`repro_torch.serving.GenerateDriver` packs them into
position-aligned batches.  Weights are random, drawn from seed 0 on the
device; prompts are drawn from seed 1 on the host.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.nn import count_params
from repro_torch.serving import BatchPolicy, GenerateDriver


def _request_stream(cfg, n_requests, prompt_len, seed=1):
    """Per-request prompts, like a front end."""
    rng = np.random.default_rng(seed)
    for _ in range(n_requests):
        yield torch.as_tensor(rng.integers(0, cfg.vocab, prompt_len),
                              dtype=torch.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=None,
                    help="number of single-prompt requests (default: batch)")
    ap.add_argument("--batch", type=int, default=4,
                    help="deprecated alias for --max-batch")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke).scaled(use_kernels=True)
    params = M.init_params(cfg, 0, device=device)
    print(f"arch={cfg.name} params={count_params(params):,}")

    max_batch = args.max_batch or args.batch
    n_requests = args.requests or max_batch
    cache_len = args.cache_len or (args.prompt_len + args.new_tokens)
    policy = BatchPolicy(max_batch=max_batch, max_wait_ms=args.max_wait_ms)

    # autostart=False: enqueue the full wave first so the opening flush
    # already packs max_batch-sized aligned batches (steady-state shape).
    driver = GenerateDriver(params, cfg, cache_len=cache_len, policy=policy,
                            greedy=args.greedy, autostart=False)
    t0 = time.monotonic()
    futures = [driver.submit(prompt, args.new_tokens)
               for prompt in _request_stream(cfg, n_requests,
                                             args.prompt_len)]
    driver.start()
    results = [f.result() for f in futures]
    dt = time.monotonic() - t0
    driver.close()

    stats = driver.metrics()["overall"]
    tok = n_requests * args.new_tokens
    print(f"served {n_requests} requests ({tok} new tokens) in {dt*1e3:.0f}ms"
          f" ({tok/dt:.0f} tok/s)")
    print(f"batches={stats['batches']} occupancy={stats['batch_occupancy']}"
          f" p50={stats['latency']['p50_ms']:.0f}ms"
          f" p99={stats['latency']['p99_ms']:.0f}ms")
    gen = torch.stack(results).cpu().numpy()
    print(f"generated[0,:16] = {gen[0, :16].tolist()}")
    return gen


if __name__ == "__main__":
    main()
