"""Logical-axis sharding that really executes: two ``gloo`` processes on
the CPU.

One run of two ranks (``mp.spawn``, rendezvous through a file under the
test's ``tmp_path``, one ``subprocess.run`` with a time limit) does, on
the meshes ``(2,)`` ``("data",)`` and ``(1, 2)`` ``("data", "model")``:

* smoke cells laid out as the dry-run lays them out (``param_shardings``,
  ``head_fallback`` for decode, the train state, the decode cache, the
  tokens split over the batch axis) and run under ``use_mesh_rules``: a
  prefill of 4 x 16 tokens of Qwen3, Granite-MoE, Mamba2 and Zamba2; a
  decode step of Qwen3 after an 8-token prefill, and of a one-KV-head
  Qwen3 whose cache splits the head dim; one train step of Qwen3 and of
  Granite-MoE in 2 microbatches; a Qwen3 prefill under ``sp_rules``
  (sequence parallel: each device attends its own queries).  Each
  output (logits, the new cache; loss, grad norm, updated params and
  Adam moments) must equal the same step on one device within
  ``rtol = atol = 1e-5`` (float32: the sharded run sums in another
  order);
* :class:`DeviceCounter` counts the collectives each rank issues; the
  dry-run's fake-group trace of the same cell (``lower_cell`` on a meta
  mesh of the same shape, in the spawning process afterwards) must
  predict the same number of collectives and the same bytes by op and by
  mesh axis;
* the elastic cases of the reference (``tests/test_fault_tolerance.py``
  and ``tests/test_training.py``): a checkpoint saved from one device is
  restored under replicated and under ``param_shardings`` layouts, a
  (4, 4) array under a row split, and ``sharded_batch`` gives the same
  global batch on both meshes;
* ``launch.mesh.make_host_mesh`` spans the two ranks;
* ``launch.train.main --device cpu --smoke`` over the two ranks' host
  mesh, against the same command in one process (the spawning process,
  before and after the ranks run): the losses within ``TOL``; a run cut
  at step 2 and resumed equals the unbroken 4-step run bit for bit; a
  checkpoint the two ranks wrote (rank 0 alone writing) resumes in one
  process and one written in one process resumes on the two ranks, each
  ending on the unbroken run's state;
* ``GenerateDriver`` serving DTensor parameters under ``use_mesh_rules``
  on the two ranks: the same tokens as one device, ``constrain`` reached
  from the worker thread, batches formed by count in the same order on
  both ranks (a hang fails the run's time limit).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300                     # seconds; the run takes ~50 here
TOL = 1e-5

_WORKER = textwrap.dedent("""
    import json
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    MESHES = (((2,), ("data",)), ((1, 2), ("data", "model")))
    B, S, P = 4, 16, 8
    #: (kind, config): prefill B x S; decode one token of B after a
    #: prefill of P into a cache of S; one train step of B x (S + 1) in 2
    #: microbatches
    CELLS = (("prefill", "qwen3-1.7b"), ("prefill", "granite-moe-3b-a800m"),
             ("prefill", "mamba2-2.7b"), ("prefill", "zamba2-2.7b"),
             ("decode", "qwen3-1.7b"), ("decode", "qwen3-1.7b-mqa"),
             ("train", "qwen3-1.7b"), ("train", "granite-moe-3b-a800m-g16"),
             ("seqpar", "qwen3-1.7b"))


    def config(name):
        '''The smoke config of ``name``.  ``-mqa``: one KV head, so the
        decode cache takes ``head_fallback``'s split of the head dim;
        ``-g16``: MoE dispatch groups of 16 tokens, which divide a
        device's rows of a microbatch, so that its groups are those of
        one device (the smoke's 64 do not).'''
        import dataclasses

        from repro_torch.configs.registry import get_config
        if name.endswith("-mqa"):
            return dataclasses.replace(
                get_config(name[:-4], smoke=True), n_kv_heads=1)
        if name.endswith("-g16"):
            return dataclasses.replace(
                get_config(name[:-4], smoke=True), moe_group=16)
        return get_config(name, smoke=True)


    def key(kind, name, shape):
        tag = f"{name}@{'x'.join(map(str, shape))}"
        return tag if kind == "prefill" else f"{kind}:{tag}"


    def shape_cell(kind):
        from repro_torch.configs.base import ShapeCell
        kind = "prefill" if kind == "seqpar" else kind
        return ShapeCell(kind, kind, S, B)


    def rules_of(kind):
        '''``seqpar``: a prefill under the sequence-parallel rules.'''
        from repro_torch.distributed.sharding import default_rules, sp_rules
        return sp_rules() if kind == "seqpar" else default_rules()


    def train_config():
        from repro_torch.training.train_step import TrainConfig
        return TrainConfig(microbatches=2)


    def full(x):
        from torch.distributed.tensor import DTensor
        return x.full_tensor() if isinstance(x, DTensor) else x


    def compare(got, want):
        '''(max |got - want|, max |want|) over two trees of tensors.'''
        from repro_torch.models.nn import tree_leaves
        g = [full(t).float() for t in tree_leaves(got)]
        w = [t.float() for t in tree_leaves(want)]
        assert len(g) == len(w) and all(a.shape == b.shape
                                        for a, b in zip(g, w))
        return (max(float((a - b).abs().max()) for a, b in zip(g, w)),
                max(float(b.abs().max()) for b in w))


    def run_cell(kind, cfg, mesh, rules):
        '''(what one device computes, the same sharded on ``mesh``, the
        counter of the sharded run), each a tree of tensors.'''
        from torch.distributed.tensor.experimental import \
            implicit_replication

        from repro_torch.distributed.sharding import (
            NamedSharding, distribute, param_shardings, use_mesh_rules)
        from repro_torch.launch.dryrun import (
            DeviceCounter, _batch_part, _distribute_cache, _distribute_tree,
            axis_of_groups)
        from repro_torch.models import model as M
        from repro_torch.serving import engine as E
        from repro_torch.training import optimizer as O
        from repro_torch.training.train_step import (TrainState, init_state,
                                                     train_step)
        rng = np.random.default_rng(1)
        tokens = torch.as_tensor(rng.integers(
            0, cfg.vocab, (B, S + 1 if kind == "train" else S)))
        bsh = NamedSharding(mesh, (_batch_part(mesh, rules, B),))
        _, axes = M.init_params(cfg, device="meta", with_axes=True)
        counter = DeviceCounter(axis_of_groups(mesh))
        if kind == "train":
            tc = train_config()
            st = init_state(cfg, 0, device="cpu")
            psh = param_shardings(axes, st.params, rules, mesh)
            dst = TrainState(params=_distribute_tree(st.params, psh),
                             opt=O.OptState(
                                 step=distribute(st.opt.step,
                                                 NamedSharding(mesh, ())),
                                 mu=_distribute_tree(st.opt.mu, psh),
                                 nu=_distribute_tree(st.opt.nu, psh),
                                 master=_distribute_tree(st.opt.master,
                                                         psh)))
            tok = distribute(tokens, bsh)
            with use_mesh_rules(mesh, rules), implicit_replication(), \
                    counter:
                gst, gm = train_step(cfg, tc, dst, tok)
            # the sharded run read the state's slices: start again from the
            # seed (the step updates its state in place)
            wst, wm = train_step(cfg, tc, init_state(cfg, 0, device="cpu"),
                                 tokens)

            # the loss is the mean over the microbatches, whose rows differ
            # under a batch split (each device's microbatch is a slice of
            # its own rows): ``nll`` and ``aux``, the last one's, differ too
            def out(st_, m):
                return {"metrics": {k: m[k] for k in ("loss", "grad_norm")},
                        "params": st_.params, "mu": st_.opt.mu,
                        "nu": st_.opt.nu}
            return out(wst, wm), out(gst, gm), counter
        params = M.init_params(cfg, 0, device="cpu")
        if kind in ("prefill", "seqpar"):
            want, _ = E.prefill(params, cfg, tokens, S)
            psh = param_shardings(axes, params, rules, mesh)
            dp, tok = _distribute_tree(params, psh), distribute(tokens, bsh)
            with use_mesh_rules(mesh, rules), implicit_replication(), \
                    counter:
                got, _ = E.prefill(dp, cfg, tok, S)
            return want, got, counter
        _, cache = E.prefill(params, cfg, tokens[:, :P], S)
        token = tokens[:, P:P + 1]
        want = E.decode_step(params, cfg, cache, token)
        psh = param_shardings(axes, params, rules, mesh, head_fallback=True)
        dp = _distribute_tree(params, psh)
        dc = _distribute_cache(cache, mesh, rules)
        tok = distribute(token, bsh)
        with use_mesh_rules(mesh, rules), implicit_replication(), counter:
            got = E.decode_step(dp, cfg, dc, tok)
        return want, got, counter


    def sharded_cells(rank, out):
        from torch.distributed.device_mesh import init_device_mesh

        res = {}
        for shape, names in MESHES:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            for kind, name in CELLS:
                want, got, counter = run_cell(kind, config(name), mesh,
                                              rules_of(kind))
                err, scale = compare(got, want)
                res[key(kind, name, shape)] = {
                    "err": err, "scale": scale,
                    "parts": {k: compare(got[k], want[k]) for k in want}
                    if isinstance(want, dict) else None,
                    "n_collectives": counter.n_collectives,
                    "coll_by_op_mb": {k: v / 1e6 for k, v in
                                      counter.coll_by_op.items() if v},
                    "coll_by_axis_mb": {k: v / 1e6 for k, v in
                                        counter.coll_by_axis.items() if v},
                }
        return res


    def elastic(rank, out):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor

        from repro_torch.configs.registry import get_config
        from repro_torch.distributed.sharding import (
            NamedSharding, default_rules, param_shardings)
        from repro_torch.launch import mesh as MS
        from repro_torch.models import model as M
        from repro_torch.models.nn import tree_leaves, tree_map
        from repro_torch.training import checkpoint as ckpt
        from repro_torch.training import data as D
        from repro_torch.training.train_step import init_state
        cfg = get_config("qwen3-1.7b", smoke=True)
        d = out + "/ck"
        st = init_state(cfg, 0, device="cpu")
        w = {"w": torch.arange(16.0).reshape(4, 4)}
        if rank == 0:
            ckpt.save(d, 1, st.tree(), extra={"step": 1})
            ckpt.save(out + "/ckw", 1, w)
        dist.barrier()
        _, axes = M.init_params(cfg, device="meta", with_axes=True)
        dc = D.DataConfig(vocab=cfg.vocab, seq_len=12, global_batch=4,
                          seed=5)
        host = MS.make_host_mesh("cpu")
        res = {"host_mesh": [list(host.shape), list(host.mesh_dim_names)]}
        for shape, names in MESHES:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            tag = "x".join(map(str, shape))
            rep = tree_map(lambda _: NamedSharding(mesh, ()), st.tree())
            tree, extra = ckpt.restore(d, st.tree(), shardings=rep)
            leaves = tree_leaves(tree)
            res[f"replicated@{tag}"] = (
                extra["step"] == 1
                and all(isinstance(x, DTensor) for x in leaves)
                and all(all(p.is_replicate() for p in x.placements)
                        for x in leaves)
                and all(torch.equal(x.to_local(), y) for x, y in
                        zip(leaves, tree_leaves(st.tree()))))
            psh = param_shardings(axes, st.params, default_rules(), mesh)
            got, _ = ckpt.restore(d, {"params": st.params},
                                  shardings={"params": psh})
            res[f"resharded@{tag}"] = all(
                tuple(x.placements) == sh.placements
                and torch.equal(x.full_tensor(), y)
                for x, y, sh in zip(tree_leaves(got["params"]),
                                    tree_leaves(st.params),
                                    tree_leaves(psh)))
            rows = NamedSharding(mesh, ("data",))
            gw, _ = ckpt.restore(out + "/ckw", w, shardings={"w": rows})
            res[f"rows@{tag}"] = (
                tuple(gw["w"].placements) == rows.placements
                and tuple(gw["w"].to_local().shape) == (4 // shape[0], 4)
                and torch.equal(gw["w"].full_tensor(), w["w"]))
            b = D.sharded_batch(dc, 7, mesh)
            res[f"batch@{tag}"] = (
                tuple(b.to_local().shape) == (4 // shape[0], 13)
                and np.array_equal(b.full_tensor().numpy(),
                                   D.global_batch(dc, 7)))
        return res


    #: launch.train.main's flags: Qwen3's smoke config, 4 steps of 4 x 16
    #: in 2 microbatches, a checkpoint every 2 steps
    TRAIN_ARGV = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                  "--batch", "4", "--seq", "16", "--microbatches", "2",
                  "--ckpt-every", "2", "--log-every", "1"]


    def train(steps, ckpt_dir=None):
        '''``launch.train.main`` for ``steps``: (its losses and grad norms,
        its final state whole as numpy arrays).'''
        from repro_torch.launch import train as TL
        from repro_torch.models.nn import tree_leaves
        rows = []
        argv = TRAIN_ARGV + ["--steps", str(steps)] + (
            ["--ckpt-dir", ckpt_dir] if ckpt_dir else [])
        st = TL.main(argv, on_metrics=lambda s, m, t: rows.append(
            [s, float(m["loss"]), float(m["grad_norm"])]))
        return rows, [full(x).numpy() for x in tree_leaves(st.tree())]


    def same_state(a, b):
        return len(a) == len(b) and all(
            x.shape == y.shape and x.dtype == y.dtype
            and x.tobytes() == y.tobytes()
            for x, y in zip(a, b))


    def launcher(rank, out):
        '''On the two ranks: the unbroken run, a run cut at step 2 and
        resumed, and a resume of the one-process checkpoint (its step 2);
        ``checkpoint.save`` calls counted on this rank.'''
        from repro_torch.training import checkpoint as ckpt
        writes = []
        kept = ckpt.save

        def counting(*a, **k):
            writes.append(a[1])
            return kept(*a, **k)
        ckpt.save = counting
        try:
            whole, final = train(4)
            cut, _ = train(2, out + "/ck2")
            resumed, final2 = train(4, out + "/ck2")
            from1, _ = train(4, out + "/ck1")
        finally:
            ckpt.save = kept
        if rank == 0:
            np.savez(out + "/ranks_final.npz", *final)
        return {"whole": whole, "cut": cut, "resumed": resumed,
                "from_one": from1, "resume_equal": same_state(final, final2),
                "from_one_restored": same_state(
                    restored(out + "/ck1", 2),
                    npz_leaves(out + "/one_step2.npz")),
                "writes": writes}


    def restored(ckpt_dir, step):
        '''The launcher's state restored from ``ckpt_dir`` at ``step`` onto
        the host mesh as the launcher lays it out, whole, as numpy.'''
        from repro_torch.launch import mesh as MS
        from repro_torch.launch import train as TL
        from repro_torch.models.nn import tree_leaves
        from repro_torch.training import checkpoint as ckpt
        args = TL.parse_args(TRAIN_ARGV + ["--steps", "4"])
        world = TL.make_world(*TL.configs(args), MS.make_host_mesh("cpu"))
        sh = world["state_shardings"]
        tree, _ = ckpt.restore(ckpt_dir, world["state"].tree(), step=step,
                               shardings={"params": sh.params,
                                          "opt": sh.opt._asdict()})
        return [full(x).numpy() for x in tree_leaves(tree)]


    def npz_leaves(path):
        arrs = np.load(path)
        return [arrs[f"arr_{i}"] for i in range(len(arrs.files))]


    def serving(rank, out):
        '''Qwen3's smoke config served through ``GenerateDriver`` with its
        parameters as DTensors on the host mesh, under the launcher's
        rules, against the same requests on one device: 6 prompts of 8
        tokens and 3 of 5, ``max_batch`` 4, the worker started after the
        requests (4 of the 6 fill a batch; the rest flush at ``drain``).'''
        import threading
        from torch.distributed.tensor import DTensor
        from repro_torch.configs.registry import get_config
        from repro_torch.distributed import sharding as SH
        from repro_torch.launch import mesh as MS
        from repro_torch.launch.train import host_rules
        from repro_torch.models import layers, model as M
        from repro_torch.models.nn import tree_map
        from repro_torch.serving import BatchPolicy, GenerateDriver
        cfg = get_config("qwen3-1.7b", smoke=True)
        params = M.init_params(cfg, 0, device="cpu")
        rng = np.random.default_rng(3)
        prompts = [torch.as_tensor(rng.integers(0, cfg.vocab, n),
                                   dtype=torch.int32)
                   for n in (8,) * 6 + (5,) * 3]

        def serve(p):
            d = GenerateDriver(p, cfg, cache_len=16, autostart=False,
                               policy=BatchPolicy(max_batch=4,
                                                  max_wait_ms=0.0))
            futs = [d.submit(x, 6) for x in prompts]
            d.start()
            d.drain()
            got = [f.result(timeout=60) for f in futs]
            d.close()
            return torch.stack(got), d
        want, _ = serve(params)
        mesh = MS.make_host_mesh("cpu")
        rules = host_rules()
        _, axes = M.init_params(cfg, device="meta", with_axes=True)
        dp = tree_map(SH.distribute, params,
                      SH.param_shardings(axes, params, rules, mesh))
        seen = []
        kept = (layers.constrain, M.constrain)

        def spy(x, *a, **k):
            if threading.current_thread() is not threading.main_thread():
                seen.append(SH.active_mesh_rules() is not None
                            and isinstance(x, DTensor))
            return kept[0](x, *a, **k)
        layers.constrain = M.constrain = spy
        try:
            with SH.use_mesh_rules(mesh, rules):
                got, d = serve(dp)
        finally:
            layers.constrain, M.constrain = kept
        groups = d.metrics()["groups"]
        return {"equal": bool(torch.equal(got, want)),
                "worker_constrains": len(seen), "under_rules": all(seen),
                "by_count": d._sched.by_count,
                "batches": {k: g["batches"] for k, g in groups.items()}}


    def rank_main(rank, world, init, out):
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        try:
            res = {"cells": sharded_cells(rank, out),
                   "elastic": elastic(rank, out),
                   "launcher": launcher(rank, out),
                   "serving": serving(rank, out)}
            with open(f"{out}/rank{rank}.json", "w") as f:
                json.dump(res, f)
        finally:
            dist.destroy_process_group()


    def predictions(out):
        from repro_torch.launch import mesh as MS
        from repro_torch.launch.dryrun import lower_cell
        res = {}
        try:
            for shape, names in MESHES:
                for kind, name in CELLS:
                    rec = lower_cell(
                        name, shape_cell(kind), rules=rules_of(kind),
                        cfg_override=config(name), tc=train_config(),
                        mesh_override=(shape, names), device="cpu")
                    res[key(kind, name, shape)] = {
                        k: rec[k] for k in ("n_collectives",
                                            "coll_by_op_mb",
                                            "coll_by_axis_mb")}
        finally:
            MS.release()
        with open(f"{out}/predicted.json", "w") as f:
            json.dump(res, f)


    def one_process(out, after):
        '''The launcher in this process alone: before the ranks run, the
        unbroken run and a checkpoint at step 2 (``ck1``); after, a resume
        of the ranks' checkpoint at step 4 (``ck2``), which takes no step.'''
        if not after:
            whole, _ = train(4)
            _, step2 = train(2, out + "/ck1")
            np.savez(out + "/one_step2.npz", *step2)
            res = {"whole": whole}
        else:
            rows, final = train(4, out + "/ck2")
            res = {"steps_after": rows, "equal": same_state(
                final, npz_leaves(out + "/ranks_final.npz"))}
        assert not dist.is_initialized()
        with open(f"{out}/one_{'after' if after else 'before'}.json",
                  "w") as f:
            json.dump(res, f)


    if __name__ == "__main__":
        init, out = sys.argv[1], sys.argv[2]
        one_process(out, after=False)
        mp.spawn(rank_main, args=(2, init, out), nprocs=2, join=True)
        one_process(out, after=True)
        predictions(out)
        print("PG-OK")
""")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding_pg")
    (tmp / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, str(tmp / "worker.py"), f"file://{tmp}/pg",
         str(tmp)], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert r.returncode == 0 and "PG-OK" in r.stdout, (
        r.stdout[-2000:] + r.stderr[-3000:])
    ranks = [json.loads((tmp / f"rank{i}.json").read_text())
             for i in range(2)]
    for i, when in enumerate(("before", "after")):
        ranks[i]["one"] = json.loads((tmp / f"one_{when}.json").read_text())
    return ranks, json.loads((tmp / "predicted.json").read_text())


MESH_TAGS = ["2", "1x2"]
PREFILLS = [f"{name}@{tag}" for tag in MESH_TAGS for name in (
    "qwen3-1.7b", "granite-moe-3b-a800m", "mamba2-2.7b", "zamba2-2.7b")]
STEPS = [f"{kind}:{name}@{tag}" for tag in MESH_TAGS for kind, name in (
    ("decode", "qwen3-1.7b"), ("decode", "qwen3-1.7b-mqa"),
    ("train", "qwen3-1.7b"), ("train", "granite-moe-3b-a800m-g16"),
    ("seqpar", "qwen3-1.7b"))]
CELLS = PREFILLS + STEPS


def _close(ranks, cell):
    for res in ranks:
        got = res["cells"][cell]
        assert got["err"] <= TOL * max(1.0, got["scale"]), (
            got["err"], got["scale"], got["parts"])


@pytest.mark.parametrize("cell", PREFILLS)
def test_sharded_prefill_equals_one_device(run, cell):
    _close(run[0], cell)


@pytest.mark.parametrize("cell", STEPS)
def test_sharded_step_equals_one_device(run, cell):
    """Decode: the logits and the new cache; train: the loss and grad
    norm, the updated params and both Adam moments; seqpar: the logits of
    a prefill whose attention splits the queries over 'model'."""
    _close(run[0], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_collectives_equal_the_fake_group_trace(run, cell):
    ranks, predicted = run
    want = predicted[cell]
    assert want["n_collectives"] > 0
    for res in ranks:
        got = res["cells"][cell]
        assert got["n_collectives"] == want["n_collectives"]
        assert got["coll_by_op_mb"] == want["coll_by_op_mb"]
        assert got["coll_by_axis_mb"] == want["coll_by_axis_mb"]


@pytest.mark.parametrize("tag", MESH_TAGS)
def test_elastic_restore_changes_sharding(run, tag):
    ranks, _ = run
    for res in ranks:
        assert res["elastic"][f"replicated@{tag}"]
        assert res["elastic"][f"resharded@{tag}"]


@pytest.mark.parametrize("tag", MESH_TAGS)
def test_checkpoint_elastic_restore_resharded(run, tag):
    ranks, _ = run
    for res in ranks:
        assert res["elastic"][f"rows@{tag}"]


@pytest.mark.parametrize("tag", MESH_TAGS)
def test_data_pipeline_survives_remesh(run, tag):
    ranks, _ = run
    for res in ranks:
        assert res["elastic"][f"batch@{tag}"]


def test_host_mesh_spans_the_process_group(run):
    ranks, _ = run
    for res in ranks:
        assert res["elastic"]["host_mesh"] == [[2], ["data"]]


def test_launcher_on_two_ranks_equals_one_process(run):
    """``launch.train.main`` over the two ranks' host mesh: the same steps
    as one process, losses and grad norms within ``TOL``."""
    ranks, _ = run
    one = ranks[0]["one"]["whole"]
    for res in ranks:
        got = res["launcher"]["whole"]
        assert [r[0] for r in got] == [r[0] for r in one] == [0, 1, 2, 3]
        np.testing.assert_allclose([r[1:] for r in got],
                                   [r[1:] for r in one], rtol=TOL, atol=TOL)


def test_launcher_resume_on_two_ranks_is_bit_identical(run):
    """Cut at step 2 and resumed: the losses and the final state of the
    unbroken 4-step run, bit for bit; only rank 0 wrote the checkpoints
    (each run saves at step 2 or 4 and again at its end)."""
    ranks, _ = run
    for rank, res in enumerate(ranks):
        la = res["launcher"]
        assert [r[0] for r in la["resumed"]] == [2, 3]
        assert la["cut"] + la["resumed"] == la["whole"]
        assert la["resume_equal"]
        assert la["writes"] == ([2, 2, 4, 4, 4, 4] if rank == 0 else [])


def test_checkpoints_move_between_one_and_two_ranks(run):
    """A checkpoint the two ranks wrote resumes in one process (at step 4:
    no step taken, the ranks' final state bit for bit), and one written in
    one process (step 2) restores on the two ranks bit for bit and resumes
    there with the unbroken run's losses."""
    ranks, _ = run
    after = ranks[1]["one"]
    assert after["steps_after"] == [] and after["equal"]
    for res in ranks:
        la = res["launcher"]
        assert [r[0] for r in la["from_one"]] == [2, 3]
        assert la["from_one_restored"]
        np.testing.assert_allclose([r[1:] for r in la["from_one"]],
                                   [r[1:] for r in la["whole"][2:]],
                                   rtol=TOL, atol=TOL)


def test_generate_driver_under_mesh_rules_on_two_ranks(run):
    """``GenerateDriver`` with DTensor parameters inside
    ``use_mesh_rules``: the tokens of one device, ``constrain`` reached from
    the worker thread under the process-default rules, and the batches
    formed by count (the same on both ranks)."""
    ranks, _ = run
    for res in ranks:
        sv = res["serving"]
        assert sv["equal"] and sv["by_count"]
        assert sv["worker_constrains"] > 0 and sv["under_rules"]
        assert sv["batches"] == ranks[0]["serving"]["batches"]
        assert sorted(sv["batches"].values()) == [1, 2]
