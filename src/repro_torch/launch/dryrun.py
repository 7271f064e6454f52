"""Fleet dry-run: trace every (arch x shape x mesh) cell on an H100 fleet
that is not there, and report per-device memory and three roofline terms.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each cell with GSPMD shardings for 512 placeholder TPU devices.  Here a
cell runs for real, once, on DTensors whose shards are meta tensors (no
memory, no arithmetic), over a ``"fake"`` process group that plays rank 0
of the fleet (``launch/mesh.py``):

  * parameters come from ``init_params(device="meta")`` laid out by
    ``param_shardings`` (``head_fallback`` only for decode), the train
    state and the decode cache as the reference lays them out, the batch
    dim split over the batch axes where it divides;
  * the step — ``train_step`` (4 microbatches), ``engine.prefill`` or
    ``engine.decode_step`` — runs under ``use_mesh_rules`` (the model's
    ``constrain`` sites redistribute) and DTensor's implicit replication
    of the plain tensors the model makes (positions, masks, scalars);
  * :class:`DeviceCounter`, a dispatch mode below DTensor, sees the ops
    this device runs on its own shards: it counts their FLOPs (the matmul
    formulas of ``torch.utils.flop_counter``), the bytes of the matmul
    operands and results (``dot_bytes``), every collective's bytes by op
    and by mesh axis, and the peak of live bytes, the arguments included
    (a storage is live from its first output until it is freed).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch qwen3-1.7b --cell decode_32k

The fake group is the process's default group: a sweep owns it for its
lifetime and destroys it at the end, so run the dry-run in a process of
its own.  Records append to ``--out`` (JSONL), and a rerun resumes.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref
from collections import Counter, defaultdict
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import (ARCHS, get_config, input_specs,
                                          iter_cells)
from repro_torch.device import Device
from repro_torch.distributed.sharding import (REDISTRIBUTIONS, NamedSharding,
                                              default_rules, distribute,
                                              param_shardings, spec_for,
                                              use_mesh_rules)
from repro_torch.launch import mesh as MS
from repro_torch.models import model as M
from repro_torch.models.nn import tree_map
from repro_torch.roofline.analysis import Roofline, model_flops_for_cell
from repro_torch.serving import engine as E
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import TrainConfig, TrainState, train_step

aten = torch.ops.aten

#: the functional collectives DTensor issues, by the reference's op names
COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all", "broadcast": "broadcast",
               "broadcast_": "broadcast"}
_COLL_NS = ("_c10d_functional", "_c10d_functional_autograd")
#: the matmuls whose operand and result bytes make ``dot_bytes``
DOTS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class DeviceCounter(TorchDispatchMode):
    """Counts what one device runs: entered around a step on DTensors, it
    hands every op with a DTensor argument on to DTensor (returns
    ``NotImplemented``) and sees the ops DTensor then runs on the local
    shards, and the collectives it issues.  DTensor's own sharding
    propagation (on fake tensors, and its decompositions on global-shape
    meta tensors) is not counted.  On plain tensors it counts the same
    quantities of a run on one device.

    ``axis_of`` maps a process group's name to its mesh axis."""

    def __init__(self, axis_of: Optional[Dict[str, str]] = None):
        super().__init__()
        self.axis_of = axis_of or {}
        self.flops = 0
        self.dot_bytes = 0
        self.coll_by_op: Dict[str, int] = defaultdict(int)
        self.coll_by_axis: Dict[str, int] = defaultdict(int)
        self.n_collectives = 0
        self.top: Counter = Counter()
        self.live = 0
        self.peak = 0
        self.arg_bytes = 0
        self._alive: Dict[int, int] = {}

    # -- live bytes ---------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage live until it is freed (once per storage);
        returns the bytes added."""
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        key = st._cdata
        if key in self._alive:
            return 0
        n = st.nbytes()
        self._alive[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return n

    def hold_args(self, args) -> None:
        """Count the arguments' shards live from the start."""
        self.arg_bytes += sum(self._hold(t) for t in _tensors(args))

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is aten.equal.default and args[0].device.type == "meta":
            # meta shards hold no data: DTensor's check that two masks of
            # a masked partial sum agree cannot run, and they do (SPMD)
            return True
        if func is aten._local_scalar_dense.default and \
                args[0].device.type == "meta":
            # a scalar read (``.item()``) of a meta shard, e.g. a 0-d
            # optimizer scalar DTensor passes on as a number: no value
            return True if args[0].dtype == torch.bool else 1
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(t, FakeTensor) for t in outs) or \
                _in_propagation():
            return out                       # DTensor's shape propagation
        self._count(func, args, kwargs, out, outs)
        for t in outs:
            self._hold(t)
        return out

    def _count(self, func, args, kwargs, out, outs) -> None:
        from torch.utils.flop_counter import flop_registry
        pkt = func._overloadpacket
        if func.namespace in _COLL_NS:
            kind = COLLECTIVES.get(func._opname)
            if kind is None:
                return                                       # wait_tensor
            group = [a for a in args if isinstance(a, str)][-1]
            axis = self.axis_of.get(group, group)
            ins = _tensors(args)
            nbytes = max(_nbytes(ins), _nbytes(outs))
            self.coll_by_op[kind] += nbytes
            self.coll_by_axis[axis] += nbytes
            self.n_collectives += 1
            shape = "x".join(map(str, ins[0].shape)) if ins else ""
            self.top[f"{kind} {axis} {ins[0].dtype if ins else ''}"
                     f"[{shape}]"] += nbytes
            return
        if pkt in flop_registry:
            self.flops += int(flop_registry[pkt](*args, **kwargs,
                                                 out_val=out))
            if pkt in DOTS:
                self.dot_bytes += _nbytes(_tensors(args)) + _nbytes(outs)


#: DTensor's sharding propagation, which runs ops on global shapes (on
#: fake tensors, and for decompositions on meta tensors): not this
#: device's work
_PROPAGATION = ("_sharding_prop.py", "_decompositions.py")


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.endswith(_PROPAGATION) and "tensor" in name:
            return True
        f = f.f_back
    return False


def axis_of_groups(mesh) -> Dict[str, str]:
    """``{process group name: mesh axis}`` for every dim of ``mesh``."""
    return {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def _batch_part(mesh, rules, batch: int):
    """Batch-dim partition with divisibility fallback (long_500k has B=1):
    the spec entry of the rules' logical ``batch`` axis."""
    spec = spec_for(("batch",), (batch,), rules.acts, mesh)
    return spec[0] if spec else None


def _distribute_tree(tree, shardings, requires_grad: bool = False):
    return tree_map(lambda t, sh: distribute(t, sh, requires_grad),
                    tree, shardings)


def _state(p_shapes, psh, mesh) -> TrainState:
    """The train state laid out as the reference's ``_state_shardings``:
    params, ``mu``, ``nu`` and ``master`` as the params, ``step``
    replicated."""
    def f32():
        return tree_map(lambda t, sh: distribute(
            torch.empty(t.shape, dtype=torch.float32, device="meta"), sh),
            p_shapes, psh)
    step = distribute(torch.empty((), dtype=torch.int32, device="meta"),
                      NamedSharding(mesh, ()))
    return TrainState(params=_distribute_tree(p_shapes, psh),
                      opt=O.OptState(step=step, mu=f32(), nu=f32(),
                                     master=f32()))


def _cache_spec(name: str, leaf: torch.Tensor, mesh, rules) -> tuple:
    """A decode cache leaf's spec by its role (``dryrun.py:88-116``)."""
    if leaf.dim() == 0 or "pos" in name:
        return ()
    if name.endswith("k") or name.endswith("v"):
        # (L, B, ring, Kh, Dh): Dh absorbs 'model' when Kh cannot
        ax = (None, "batch", None, "kv_heads", "head")
    elif "ssm" in name:
        ax = (None, "batch", "heads_model", None, None)
    elif "conv" in name:
        ax = (None, "batch", None, "mlp")
    else:
        ax = (None,) * leaf.dim()
    rule = dict(rules.acts)
    rule.update(kv_heads="model", heads_model="model", head=None,
                mlp="model")
    return spec_for(ax, tuple(leaf.shape), rule, mesh, head_fallback=True)


def _distribute_cache(cache, mesh, rules, prefix: str = ""):
    if isinstance(cache, dict):
        return {k: _distribute_cache(v, mesh, rules, f"{prefix}/{k}")
                for k, v in cache.items()}
    return distribute(cache, NamedSharding(
        mesh, _cache_spec(prefix, cache, mesh, rules)))


# ---------------------------------------------------------------------------
# per-cell trace
# ---------------------------------------------------------------------------

def _args(cfg, cell: ShapeCell, mesh, rules, batch_ax, tc: TrainConfig):
    """The cell's arguments as DTensors over meta shards, and the step."""
    p_shapes, p_axes = M.init_params(cfg, device="meta", with_axes=True)
    specs = input_specs(cfg, cell)
    bsh = NamedSharding(mesh, (batch_ax,))
    if cell.kind == "decode":
        psh = param_shardings(p_axes, p_shapes, rules, mesh,
                              head_fallback=True)
        params = _distribute_tree(p_shapes, psh)
        cache = _distribute_cache(specs["cache"], mesh, rules)
        token = distribute(specs["token"], bsh)
        return p_shapes, (params, cache, token), \
            lambda: E.decode_step(params, cfg, cache, token)
    psh = param_shardings(p_axes, p_shapes, rules, mesh)
    tokens = distribute(specs["tokens"], bsh)
    memory = (distribute(specs["memory"], bsh) if "memory" in specs
              else None)
    if cell.kind == "train":
        state = _state(p_shapes, psh, mesh)
        return p_shapes, (state.tree(), tokens, memory), \
            lambda: train_step(cfg, tc, state, tokens, memory)
    params = _distribute_tree(p_shapes, psh)
    return p_shapes, (params, tokens, memory), \
        lambda: E.prefill(params, cfg, tokens, cell.seq_len, memory=memory)


def lower_cell(arch: str, cell: ShapeCell, *, multi_pod: bool = False,
               rules=None, extra_tag: str = "", cfg_override=None,
               tc: Optional[TrainConfig] = None, mesh_override=None,
               device: Device = None) -> Dict[str, Any]:
    """Trace one cell; return its dry-run record (or raise).

    ``mesh_override``: ``(shape, axis names)`` of another fleet layout
    (``launch/perf.py``'s ``mesh...`` variants), e.g. ``((64, 4), ("data",
    "model"))``.  ``device``: the mesh's device type (``None``: the card).
    """
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = cfg_override or get_config(arch)
    shape, axes = mesh_override or MS.production_shape(multi_pod)
    mesh = MS.fake_mesh(shape, axes, device)
    chips = math.prod(shape)
    rules = rules or default_rules(multi_pod=multi_pod)
    tc = tc or TrainConfig(microbatches=4)
    batch_ax = _batch_part(mesh, rules, cell.global_batch)
    p_shapes, args, step = _args(cfg, cell, mesh, rules, batch_ax, tc)
    counter = DeviceCounter(axis_of_groups(mesh))
    counter.hold_args(args)
    REDISTRIBUTIONS.clear()
    t0 = time.monotonic()
    with use_mesh_rules(mesh, rules), implicit_replication(), counter:
        out = step()
    trace_s = time.monotonic() - t0
    replicated = Counter(REDISTRIBUTIONS)
    del out, step, args
    rl = Roofline(
        arch=arch, cell=cell.name, mesh=MS.mesh_name(shape) + extra_tag,
        chips=chips, flops=counter.flops * chips,
        hbm_bytes=counter.dot_bytes * chips,
        coll_by_op=dict(counter.coll_by_op),
        coll_by_axis=dict(counter.coll_by_axis),
        model_flops=model_flops_for_cell(cfg, cell, p_shapes),
        per_device_bytes=counter.peak, raw_flops=counter.flops,
        top_collectives=tuple(k for k, _ in counter.top.most_common(6)))
    rec = rl.row()
    rec.update({
        "ok": True, "trace_s": round(trace_s, 1),
        "arg_gb": counter.arg_bytes / 1e9,
        "temp_gb": (counter.peak - counter.arg_bytes) / 1e9,
        "n_collectives": counter.n_collectives,
        "replicated": [f"{n} x {r}" for r, n in replicated.items()],
        "flops_perdev": counter.flops,
        "arg_bytes": counter.arg_bytes, "peak_bytes": counter.peak,
    })
    return rec


def count_step(cfg, cell: ShapeCell, tc: TrainConfig, device: Device = None,
               seed: int = 0) -> DeviceCounter:
    """One real train step of ``cell`` (kind train) on ``device``, plain
    tensors, under :class:`DeviceCounter`: what a one-card dry-run of the
    cell predicts, counted on the device.  The state is ``init_state``'s
    and the tokens are int64, as ``input_specs`` makes them."""
    from repro_torch.device import resolve_device
    from repro_torch.training.train_step import init_state
    device = resolve_device(device)
    state = init_state(cfg, seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    specs = input_specs(cfg, cell)
    tokens = torch.randint(0, cfg.vocab, tuple(specs["tokens"].shape),
                           generator=gen, device=device)
    memory = None
    if "memory" in specs:
        memory = torch.randn(tuple(specs["memory"].shape), generator=gen,
                             device=device).to(cfg.torch_dtype)
    counter = DeviceCounter()
    counter.hold_args((state.tree(), tokens, memory))
    with counter:
        train_step(cfg, tc, state, tokens, memory)
    return counter


def run_sweep(archs, cells, multi_pod: bool, out_path: Optional[str],
              resume: bool = True, device: Device = None) -> Dict:
    """Sweep cells; append-write JSONL so an interrupted sweep resumes
    (failed cells retry)."""
    done = set()
    if out_path and resume and os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                r = json.loads(line)
                if r.get("ok"):
                    done.add((r["arch"], r["cell"], r["mesh"]))
    results = []
    mesh_name = MS.mesh_name(MS.production_shape(multi_pod)[0])
    try:
        for arch in archs:
            for cell, skip in iter_cells(arch):
                if cells and cell.name not in cells:
                    continue
                if (arch, cell.name, mesh_name) in done:
                    continue
                if skip:
                    rec = {"arch": arch, "cell": cell.name,
                           "mesh": mesh_name, "ok": True, "skipped": skip}
                else:
                    print(f"--- {arch} x {cell.name} x {mesh_name}",
                          flush=True)
                    try:
                        rec = lower_cell(arch, cell, multi_pod=multi_pod,
                                         device=device)
                        print(f"    ok: trace {rec['trace_s']}s "
                              f"bottleneck={rec['bottleneck']} "
                              f"perdev={rec['per_device_gb']:.2f}GB",
                              flush=True)
                    except Exception as e:                 # noqa: BLE001
                        traceback.print_exc()
                        rec = {"arch": arch, "cell": cell.name,
                               "mesh": mesh_name, "ok": False,
                               "error": str(e)[:2000]}
                results.append(rec)
                if out_path:
                    with open(out_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    finally:
        MS.release()
    return {"results": results}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--cell", default=None,
                    help="one of train_4k/prefill_32k/decode_32k/long_500k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None, help="JSONL output path")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: the card)")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCHS)
    cells = [args.cell] if args.cell else None
    out = run_sweep(archs, cells, args.multi_pod, args.out,
                    resume=not args.no_resume, device=args.device)
    for r in out["results"]:
        print(json.dumps(r), flush=True)
    n_ok = sum(1 for r in out["results"] if r.get("ok"))
    print(f"\n{n_ok}/{len(out['results'])} cells OK")
    if any(not r.get("ok") for r in out["results"]):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
