"""The training launcher over the host mesh and serving under the mesh
rules, in this process on the CPU.

* ``launch.train.make_world`` on a one-rank ``gloo`` host mesh: its state
  is DTensors laid out as ``param_shardings`` says, drawn from seed 0;
  four smoke steps of its step function on the reference's weights equal
  the port's single-device ``train_step`` and the reference's
  ``repro.training.train_step`` on the same batches, within 1e-5;
* ``launch.train.main`` releases a process group it made itself and
  leaves a caller's alone;
* ``BatchScheduler(by_count=True)`` forms the same batches whatever the
  timing, and never by the timer;
* ``GenerateDriver`` serving DTensor parameters inside ``use_mesh_rules``:
  the tokens of the plain run, ``constrain`` reached from the worker
  thread.

Two ranks: ``tests/test_torch_sharding_pg.py``'s one spawn.
"""
from __future__ import annotations

import dataclasses
import importlib
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MS
from repro_torch.launch import train as TL
from repro_torch.models import model as M
from repro_torch.models.convert import config_from_fields, train_state_from_numpy
from repro_torch.models.nn import tree_leaves, tree_map
from repro_torch.serving import BatchPolicy, GenerateDriver
from repro_torch.serving.scheduler import BatchScheduler
from repro_torch.training import data
from repro_torch.training import optimizer as O

T = importlib.import_module("repro_torch.training.train_step")

TOL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
SMOKE_ARGV = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
              "--steps", "2", "--batch", "2", "--seq", "8"]


@pytest.fixture
def host_mesh():
    """The one-rank ``gloo`` host mesh, released after the test."""
    assert not dist.is_initialized()
    mesh = MS.make_host_mesh("cpu")
    yield mesh
    MS.release()
    assert not dist.is_initialized()


def test_make_world_lays_out_the_state(host_mesh):
    """Every leaf a DTensor placed as ``param_shardings`` (``mu``, ``nu``,
    ``master`` as the params, ``step`` replicated), holding seed 0's draw;
    the batch function gives the step-seeded global batch."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    dc = data.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=5)
    world = TL.make_world(cfg, T.TrainConfig(), dc, host_mesh)
    st, sh = world["state"], world["state_shardings"]
    _, axes = M.init_params(cfg, device="meta", with_axes=True)
    psh = SH.param_shardings(axes, st.params, TL.host_rules(), host_mesh)
    want = T.init_state(cfg, 0, device="cpu")
    assert sh.params == psh and sh.opt.mu == sh.opt.nu == sh.opt.master \
        == psh and sh.opt.step.spec == ()
    for leaf, s, w in zip(tree_leaves(st.tree()), tree_leaves(sh.tree()),
                          tree_leaves(want.tree())):
        assert isinstance(leaf, DTensor) and leaf.device_mesh == host_mesh
        assert tuple(leaf.placements) == s.placements
        assert torch.equal(leaf.full_tensor(), w)
    b = world["batch"](3)
    assert isinstance(b, DTensor)
    assert np.array_equal(b.full_tensor().numpy(), data.global_batch(dc, 3))
    assert world["mesh"] is host_mesh


def test_make_world_steps_equal_one_device_and_reference(host_mesh):
    """Four steps of ``make_world``'s step on the reference's weights (2
    microbatches): loss and grad norm equal the port's single-device step
    and the reference's jitted step on the same batches, within 1e-5."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as ref_get
    from repro.training import optimizer as RO
    RT = importlib.import_module("repro.training.train_step")
    rcfg = ref_get("qwen3-1.7b", smoke=True).scaled(attn_block_kv=8)
    rstate, _ = RT.init_state(rcfg, jax.random.PRNGKey(0))
    cfg = config_from_fields(dataclasses.asdict(rcfg))
    rtree = jax.tree.map(np.asarray, rstate.tree())
    rstep = jax.jit(RT.make_train_step(rcfg, RT.TrainConfig(
        microbatches=2, opt=RO.OptConfig(**OPT))))
    tc = T.TrainConfig(microbatches=2, opt=O.OptConfig(**OPT))
    dc = data.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=5)
    world = TL.make_world(cfg, tc, dc, host_mesh)
    dst = T.TrainState.from_tree(tree_map(
        SH.distribute, train_state_from_numpy(rtree, cfg, "cpu").tree(),
        world["state_shardings"].tree()))
    one = train_state_from_numpy(rtree, cfg, "cpu")
    for s in range(4):
        dst, m = world["step"](dst, world["batch"](s))
        one, m1 = T.train_step(cfg, tc, one, data.device_batch(dc, s, "cpu"))
        rstate, rm = rstep(rstate, jnp.asarray(data.global_batch(dc, s)),
                           None)
        assert not any(isinstance(v, DTensor) for v in m.values())
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(m1[k]), rtol=TOL,
                                       atol=0, err_msg=f"step {s} {k}")
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=TOL,
                                       atol=0, err_msg=f"step {s} {k}")
    assert int(dst.opt.step.full_tensor()) == 4


def test_main_releases_the_group_it_made():
    """With no process group alive, ``main`` makes the host mesh's group,
    releases it before returning and hands back plain tensors."""
    assert not dist.is_initialized()
    st = TL.main(SMOKE_ARGV)
    assert not dist.is_initialized()
    assert not any(isinstance(t, DTensor) for t in tree_leaves(st.tree()))
    assert int(st.opt.step) == 2


def test_main_keeps_a_callers_group(host_mesh):
    """Under a group the caller made, ``main`` trains on it, leaves it
    alive and hands back the DTensors it trained."""
    st = TL.main(SMOKE_ARGV)
    assert dist.is_initialized()
    leaves = tree_leaves(st.tree())
    assert all(isinstance(t, DTensor) and t.device_mesh == host_mesh
               for t in leaves)
    assert int(st.opt.step.full_tensor()) == 2


#: submissions by key, in order, and the batches they form by count
#: (``max_batch`` 3): b fills at the 6th job, a at the 7th; ``drain``
#: flushes the rest, the group with the oldest job first
KEYS = "abacbbacaab"
BY_COUNT = [("b", [1, 4, 5]), ("a", [0, 2, 6]), ("c", [3, 7]),
            ("a", [8, 9]), ("b", [10])]


def _within(fn, seconds: float = 30.0) -> None:
    """``fn()`` in a thread, which must end within ``seconds``."""
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"{fn} did not return within {seconds} s"


@pytest.mark.parametrize("run_s,submit_s", [(0.0, 0.002), (0.01, 0.0)])
def test_by_count_batches_depend_on_submissions_alone(run_s, submit_s):
    """The same batches, in the same order, whether the worker keeps up
    with the submissions or lags behind them, though the timer (0 ms)
    would flush every job at once."""
    ran = []

    def run(key, payloads):
        time.sleep(run_s)
        ran.append((key, list(payloads)))
        return payloads
    sched = BatchScheduler(run, BatchPolicy(max_batch=3, max_wait_ms=0.0),
                           by_count=True)
    futs = []
    for i, k in enumerate(KEYS):
        futs.append(sched.submit(k, i))
        time.sleep(submit_s)
    _within(sched.drain)
    assert [f.result(timeout=10) for f in futs] == list(range(len(KEYS)))
    _within(sched.shutdown)
    assert ran == BY_COUNT


def test_by_count_never_flushes_by_the_timer():
    ran = []
    sched = BatchScheduler(lambda k, p: ran.append(p) or p,
                           BatchPolicy(max_batch=3, max_wait_ms=0.0),
                           by_count=True)
    futs = [sched.submit("a", i) for i in range(2)]
    time.sleep(0.05)
    assert ran == [] and sched.queue_depth() == 2
    _within(sched.shutdown)
    assert ran == [[0, 1]] and [f.result(timeout=10) for f in futs] == [0, 1]


def test_generate_driver_under_mesh_rules(host_mesh):
    """Qwen3's smoke config served with its parameters as DTensors on the
    one-rank host mesh, inside ``use_mesh_rules``: the plain run's tokens;
    the worker thread's ``constrain`` calls see the process-default rules
    and DTensor activations; one rank forms batches as usual."""
    from repro_torch.models import layers
    cfg = get_config("qwen3-1.7b", smoke=True)
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab, 8),
                               dtype=torch.int32) for _ in range(5)]

    def serve(p):
        d = GenerateDriver(p, cfg, cache_len=16, autostart=False,
                           policy=BatchPolicy(max_batch=4, max_wait_ms=5.0))
        futs = [d.submit(x, 6) for x in prompts]
        d.start()
        got = torch.stack([f.result(timeout=60) for f in futs])
        d.close()
        return got, d
    want, _ = serve(params)
    rules = TL.host_rules()
    _, axes = M.init_params(cfg, device="meta", with_axes=True)
    dp = tree_map(SH.distribute, params,
                  SH.param_shardings(axes, params, rules, host_mesh))
    seen = []
    kept = (layers.constrain, M.constrain)

    def spy(x, *a, **k):
        if threading.current_thread() is not threading.main_thread():
            seen.append(SH.active_mesh_rules() is not None
                        and isinstance(x, DTensor))
        return kept[0](x, *a, **k)
    layers.constrain = M.constrain = spy
    try:
        with SH.use_mesh_rules(host_mesh, rules):
            got, d = serve(dp)
    finally:
        layers.constrain, M.constrain = kept
    assert torch.equal(got, want)
    assert seen and all(seen)
    assert d.device == torch.device("cpu") and d.mesh is host_mesh
    assert not d._sched.by_count
