"""LM generate driver on the continuous-batching scheduler.

The counterpart of ``repro/serving/lm_driver.py``.  Decode batches must be
*position-aligned* (one scalar ``pos`` per cache — see
``serving/engine.py``), so the batchable unit is ``(prompt_len, n_new)``:
requests with the same signature stack into one ``generate`` call (prefill + decode steps) and stream back per-request
token tensors.  It reports the same metrics as the reference driver.

    driver = GenerateDriver(params, cfg, cache_len=64)
    fut = driver.submit(prompt_tokens, n_new=16)      # (S,) int
    toks = fut.result()                               # (n_new,) int32
"""
from __future__ import annotations

import time
from concurrent.futures import Future
from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serving import engine as E
from repro_torch.serving.metrics import MetricsRegistry, merged_latency
from repro_torch.serving.scheduler import (BatchPolicy, BatchScheduler,
                                           QueueFullError)


class _GenJob:
    __slots__ = ("prompt", "t_submit")

    def __init__(self, prompt):
        self.prompt = prompt
        self.t_submit = time.monotonic()


class GenerateDriver:
    """Packs single-prompt generate requests into aligned batches.

    The batches run on the device of the model's parameters; a batch's
    latency is taken after a synchronise on that device.
    """

    def __init__(self, params, cfg: ModelConfig, *,
                 cache_len: Optional[int] = None,
                 policy: Optional[BatchPolicy] = None,
                 greedy: bool = True,
                 generator: Optional[torch.Generator] = None,
                 autostart: bool = True):
        self.params = params
        self.cfg = cfg
        self.cache_len = cache_len
        self.greedy = greedy
        self.generator = generator
        self.device = params["embed"].device
        self.metrics_registry = MetricsRegistry()
        self._sched = BatchScheduler(self._run_batch, policy,
                                     name=f"lm-{cfg.name}",
                                     autostart=autostart)

    # -- admission -----------------------------------------------------------
    def group_key(self, prompt, n_new: int) -> str:
        return f"len={prompt.shape[0]};new={n_new}"

    def submit(self, prompt, n_new: int) -> Future:
        """Enqueue one request. ``prompt`` is (S,) int; result (n_new,)."""
        prompt = torch.as_tensor(prompt)
        if prompt.dim() != 1:
            raise ValueError(
                f"prompt must be a 1-D token array, got {tuple(prompt.shape)}")
        key = (self.group_key(prompt, n_new), n_new)
        m = self.metrics_registry.group(key[0])
        try:
            fut = self._sched.submit(key, _GenJob(prompt))
        except QueueFullError:
            m.bump(rejected=1)
            raise
        m.bump(submitted=1)
        return fut

    # -- lifecycle / introspection -------------------------------------------
    def start(self) -> "GenerateDriver":
        self._sched.start()
        return self

    def drain(self) -> None:
        self._sched.drain()

    def close(self, wait: bool = True) -> None:
        self._sched.shutdown(wait=wait)

    def __enter__(self) -> "GenerateDriver":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(wait=True)

    def queue_depth(self) -> int:
        return self._sched.queue_depth()

    def metrics(self) -> dict:
        groups = [self.metrics_registry.group(k)
                  for k in self.metrics_registry.keys()]
        overall = self.metrics_registry.totals()
        overall["latency"] = merged_latency(groups).as_dict()
        overall["queue_depth"] = self._sched.queue_depth()
        return {
            "arch": self.cfg.name,
            "policy": {
                "max_batch": self._sched.policy.max_batch,
                "max_wait_ms": self._sched.policy.max_wait_ms,
                "max_queue": self._sched.policy.max_queue,
                "overflow": self._sched.policy.overflow,
            },
            "overall": overall,
            "groups": self.metrics_registry.as_dict(),
        }

    # -- execution -----------------------------------------------------------
    def _run_batch(self, key, jobs: List[_GenJob]) -> list:
        group_key, n_new = key
        m = self.metrics_registry.group(group_key)
        prompt_len = jobs[0].prompt.shape[0]
        cache_len = self.cache_len or (prompt_len + n_new)
        try:
            prompts = torch.stack([j.prompt for j in jobs]).to(
                device=self.device, dtype=torch.int32)
            toks, _ = E.generate(self.params, self.cfg, prompts, n_new,
                                 cache_len, greedy=self.greedy,
                                 generator=self.generator)
            if toks.device.type == "cuda":
                torch.cuda.synchronize(toks.device)
        except BaseException:
            m.bump(failed=len(jobs))
            raise
        now = time.monotonic()
        m.bump(batches=1, batched_jobs=len(jobs), completed=len(jobs),
               payload_elems=len(jobs) * (prompt_len + n_new),
               padded_elems=len(jobs) * (prompt_len + n_new))
        for j in jobs:
            m.observe_latency(now - j.t_submit)
        return [toks[i] for i in range(len(jobs))]
