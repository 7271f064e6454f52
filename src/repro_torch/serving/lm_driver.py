"""LM generate driver on the continuous-batching scheduler.

The counterpart of ``repro/serving/lm_driver.py``.  Decode batches must be
*position-aligned* (one scalar ``pos`` per cache — see
``serving/engine.py``), so the batchable unit is ``(prompt_len, n_new,
memory signature)``: requests with the same signature stack into one
``generate`` call (prefill + decode steps), their memories (an enc-dec
model's frames, a VLM's patches) stacked beside the prompts, and stream
back per-request token tensors.  It reports the same metrics as the
reference driver.

    driver = GenerateDriver(params, cfg, cache_len=64)
    fut = driver.submit(prompt_tokens, n_new=16)      # (S,) int
    toks = fut.result()                               # (n_new,) int32

Under the mesh rules, as in the reference: a caller that serves DTensor
parameters (laid out by ``param_shardings``) enters ``use_mesh_rules``
around the driver's life; the rules are the process default, so the
worker thread's ``constrain`` calls see them.  Each batch's prompts (and
memories) are then split over the rules' batch axes (replicated when those
do not divide the batch), and its tokens come back whole on every rank.
On a mesh of more than one rank every rank must issue the same
collectives in the same order, so the driver forms its batches by count
(``BatchScheduler(by_count=True)``: ``max_batch`` jobs of one signature,
the rest at ``drain``/``close``) and never by the ``max_wait_ms`` timer;
each rank must submit the same requests in the same order.
"""
from __future__ import annotations

import time
from concurrent.futures import Future
from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.serving import engine as E
from repro_torch.serving.metrics import MetricsRegistry, merged_latency
from repro_torch.serving.scheduler import (BatchPolicy, BatchScheduler,
                                           QueueFullError)


class _GenJob:
    __slots__ = ("prompt", "memory", "t_submit")

    def __init__(self, prompt, memory):
        self.prompt = prompt
        self.memory = memory
        self.t_submit = time.monotonic()


class GenerateDriver:
    """Packs single-prompt generate requests into aligned batches.

    The batches run on the device of the model's parameters (a DTensor's:
    this rank's); a batch's latency is taken after a synchronise on that
    device.  ``mesh``: the DeviceMesh of DTensor ``params`` (or None).
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
        embed = params["embed"]
        self.mesh = embed.device_mesh if SH.is_dtensor(embed) else None
        self.device = embed.device
        self.metrics_registry = MetricsRegistry()
        self._sched = BatchScheduler(
            self._run_batch, policy, name=f"lm-{cfg.name}",
            autostart=autostart,
            by_count=self.mesh is not None and self.mesh.size() > 1)

    # -- admission -----------------------------------------------------------
    def group_key(self, prompt, n_new: int, memory=None) -> str:
        mem = ("none" if memory is None
               else "x".join(str(s) for s in memory.shape))
        return f"len={prompt.shape[0]};new={n_new};mem={mem}"

    def submit(self, prompt, n_new: int, memory=None) -> Future:
        """Enqueue one request. ``prompt`` is (S,) int; result (n_new,).
        ``memory``, required by the enc-dec and VLM families, is the
        request's (n_frames or n_img_tokens, D) embeddings."""
        prompt = torch.as_tensor(prompt)
        if prompt.dim() != 1:
            raise ValueError(
                f"prompt must be a 1-D token array, got {tuple(prompt.shape)}")
        if self.cfg.family in ("vlm", "encdec") and memory is None:
            raise ValueError(f"family {self.cfg.family!r} requires a memory")
        if memory is not None:
            memory = torch.as_tensor(memory)
        key = (self.group_key(prompt, n_new, memory), n_new)
        m = self.metrics_registry.group(key[0])
        try:
            fut = self._sched.submit(key, _GenJob(prompt, memory))
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
                "by_count": self._sched.by_count,
                "max_batch": self._sched.policy.max_batch,
                "max_wait_ms": self._sched.policy.max_wait_ms,
                "max_queue": self._sched.policy.max_queue,
                "overflow": self._sched.policy.overflow,
            },
            "overall": overall,
            "groups": self.metrics_registry.as_dict(),
        }

    # -- execution -----------------------------------------------------------
    def _place(self, x: torch.Tensor):
        """A batch input (B, ...) on this rank's device; under a mesh, a
        DTensor split over the batch axes of the active rules (the
        default rules of the mesh outside ``use_mesh_rules``)."""
        x = x.to(self.device)
        if self.mesh is None:
            return x
        spec = SH.spec_for(("batch",), (x.shape[0],),
                           SH.rules_for(self.mesh).acts, self.mesh)
        return SH.distribute(x, SH.NamedSharding(self.mesh, spec))

    def _generate(self, prompts, memory, n_new: int, cache_len: int):
        if self.mesh is None:
            toks, _ = E.generate(self.params, self.cfg, prompts, n_new,
                                 cache_len, memory=memory, greedy=self.greedy,
                                 generator=self.generator)
            return toks
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            toks, _ = E.generate(self.params, self.cfg, self._place(prompts),
                                 n_new, cache_len,
                                 memory=(None if memory is None
                                         else self._place(memory)),
                                 greedy=self.greedy, generator=self.generator)
            return toks.full_tensor() if SH.is_dtensor(toks) else toks

    def _run_batch(self, key, jobs: List[_GenJob]) -> list:
        group_key, n_new = key
        m = self.metrics_registry.group(group_key)
        prompt_len = jobs[0].prompt.shape[0]
        cache_len = self.cache_len or (prompt_len + n_new)
        try:
            prompts = torch.stack([j.prompt for j in jobs]).to(
                device=self.device, dtype=torch.int32)
            memory = (torch.stack([j.memory for j in jobs]).to(self.device)
                      if jobs[0].memory is not None else None)
            toks = self._generate(prompts, memory, n_new, cache_len)
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
