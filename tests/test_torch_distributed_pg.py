"""The ``gloo`` process-group transport of ``repro_torch.distributed``, on
the CPU.

Two processes on mesh ``(2,)`` and four on ``(2, 2)``: every rank holds one
shard, exchanges its edges point to point (``dist.batch_isend_irecv``)
and assembles the answer once, at the end.  Each rank's ``__call__`` and
``iterate`` must equal the ``LocalTransport`` engine's (every shard in one
process) within ``rtol = atol = 1e-5``, and the verifier's step-path audit
must see exactly two exchanges per partitioned axis per step, point to
point only.  The ranks rendezvous through a file under ``tmp_path``, so
parallel test workers never share a port; each run is one
``subprocess.run`` with a time limit.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.stencil import make_stencil
from repro_torch.distributed import ShardedStencilEngine, grid_mesh

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 120                     # seconds per run; a run takes ~10 here
TOL = dict(rtol=1e-5, atol=1e-5)

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def rank_main(rank, world, parts, backend, init, out):
        from repro_torch.core.stencil import make_stencil
        from repro_torch.distributed import (ProcessGroupTransport,
                                             ShardedStencilEngine, grid_mesh)
        from repro_torch.vet import lowering
        from repro_torch.vet.config import VetConfig
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        try:
            inp = np.load(out + "/inputs.npz")
            spec = make_stencil("box", 2, 1, seed=3)
            eng = ShardedStencilEngine(
                spec, grid_mesh(parts, devices=["cpu"] * world),
                backend=backend, transport=ProcessGroupTransport())
            call = eng(torch.as_tensor(inp["x"]))
            it = eng.iterate(torch.as_tensor(inp["u"]), 3)
            calls, sent = eng.transport.calls, eng.transport.sent_bytes
            fs, counts = lowering.audit_sharded(
                VetConfig(), eng, torch.as_tensor(inp["u"]), 2, "pg")
            np.savez(f"{out}/rank{rank}.npz", call=call.numpy(),
                     iterate=it.numpy(), calls=calls, sent=sent,
                     permutes=counts["collective-permute"],
                     gathers=counts["gather-like"],
                     findings=np.asarray([f.rule for f in fs], dtype=str))
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        world, parts, backend, init, out = (int(sys.argv[1]),
                                            eval(sys.argv[2]), sys.argv[3],
                                            sys.argv[4], sys.argv[5])
        mp.spawn(rank_main, args=(world, parts, backend, init, out),
                 nprocs=world, join=True)
        print("PG-OK")
""")


@pytest.mark.parametrize("parts,backend", [((2,), "direct"),
                                           ((2, 2), "sptc")],
                         ids=["2proc-mesh2", "4proc-mesh2x2"])
def test_gloo_blocks_equal_the_local_transport(tmp_path, parts, backend):
    world = int(np.prod(parts))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(25, 23)).astype(np.float32)
    u = rng.normal(size=(23, 21)).astype(np.float32)   # non-divisible
    np.savez(tmp_path / "inputs.npz", x=x, u=u)
    (tmp_path / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, str(tmp_path / "worker.py"), str(world), repr(parts),
         backend, f"file://{tmp_path}/pg", str(tmp_path)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0 and "PG-OK" in r.stdout, (
        r.stdout[-2000:] + r.stderr[-3000:])

    spec = make_stencil("box", 2, 1, seed=3)
    local = ShardedStencilEngine(
        spec, grid_mesh(parts, devices=["cpu"] * world), backend=backend)
    want_call = local(torch.as_tensor(x)).numpy()
    want_it = local.iterate(torch.as_tensor(u), 3).numpy()
    naxes = len(parts)
    for rank in range(world):
        got = np.load(tmp_path / f"rank{rank}.npz")
        np.testing.assert_allclose(got["call"], want_call, **TOL)
        np.testing.assert_allclose(got["iterate"], want_it, **TOL)
        # 4 fused steps (1 + 3), two shifts per partitioned axis each
        assert int(got["calls"]) == 4 * 2 * naxes
        assert int(got["sent"]) > 0
        assert int(got["permutes"]) == 2 * naxes
        assert int(got["gathers"]) == 0 and got["findings"].size == 0
