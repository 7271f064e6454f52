"""The port's logical-axis sharding against the JAX reference, on the CPU.

For all ten full configs: every parameter's logical axes (the port's tree
on the meta device, the reference's ``axes_tree`` of its
``jax.eval_shape``, whose stacked ``"layers"`` dims the port's per-layer
lists do not have), and ``spec_for`` of every leaf on the meshes 16x16,
2x16x16, 32x8, 2x32x8, (8,) and (1,), with and without ``head_fallback``,
under ``default_rules`` and ``sp_rules``, equal the reference's exactly
(the reference's ``spec_for`` reads only ``mesh.shape``, so both take a
dict of axis sizes).  Also: the activation specs of the model's
``constrain`` sites, the two thread tests of the reference's
``use_mesh_rules`` (``tests/test_distributed.py:226-265``), ``constrain``
as a no-op on plain tensors (bit-identical logits), ``count_active_params``
and ``model_flops_for_cell`` for all ten archs x four cells (exact
integers), ``input_specs`` (shapes and dtypes; tokens are int64 where the
reference's are int32; the decode cache leaf for leaf and in total
bytes), the reference's synthetic ``Roofline`` case with one rate per
link, and ``variant_kwargs`` of every named variant field for field.
"""
from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPE_CELLS
from repro_torch.configs.registry import ARCHS, get_config, input_specs
from repro_torch.distributed import sharding as SH
from repro_torch.models import model as M
from repro_torch.roofline import analysis as RA

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "32x8": {"data": 32, "model": 8},
    "2x32x8": {"pod": 2, "data": 32, "model": 8},
    "8": {"data": 8},
    "1": {"data": 1},
}

#: the activation axes of the model's ``constrain`` sites and attention
ACT_AXES = [("batch", "seq", "embed"), ("batch", "seq", "vocab"),
            ("batch", None, "embed"), ("batch", "seq", "q_heads", "head"),
            ("batch", "kv_seq", "kv_heads", "head")]


class _Mesh:
    """What the reference's ``spec_for`` reads of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _ref_tree(arch):
    """The reference's (shapes, axes) trees of the full config."""
    import jax
    from repro.configs.registry import get_config as ref_get
    from repro.models import model as RM
    from repro.models.nn import axes_tree
    store = {}

    def init_fn(key):
        params, axes = RM.init_params(ref_get(arch), key)
        store.update(axes)
        return params
    shapes = jax.eval_shape(init_fn, jax.ShapeDtypeStruct((2,), np.uint32))
    return shapes, axes_tree(shapes, store)


def _port_leaves(tree, path=()):
    """(reference path, port leaf) pairs: list indices dropped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for v in tree:
            yield from _port_leaves(v, path)
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def trees():
    out = {}
    for arch in ARCHS:
        params, axes = M.init_params(get_config(arch), device="meta",
                                     with_axes=True)
        out[arch] = (params, axes) + _ref_tree(arch)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_equal_the_reference(trees, arch):
    params, axes, rshapes, raxes = trees[arch]
    import jax
    seen = set()
    for (path, ax), (_, t) in zip(_port_leaves(axes), _port_leaves(params)):
        rax, rshape = _at(raxes, path), _at(rshapes, path).shape
        stacked = len(rshape) - t.dim()
        assert rax[:stacked] == ("layers",) * stacked, path
        assert tuple(rax[stacked:]) == ax, path
        assert tuple(rshape[stacked:]) == tuple(t.shape), path
        seen.add(path)
    assert seen == {tuple(p.key for p in path) for path, _ in
                    jax.tree_util.tree_flatten_with_path(rshapes)[0]}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_equals_the_reference(trees, arch, mesh):
    from repro.distributed import sharding as RS
    params, axes, rshapes, raxes = trees[arch]
    sizes = MESHES[mesh]
    multi = "pod" in sizes
    for rules, rrules in ((SH.default_rules(multi_pod=multi),
                           RS.default_rules(multi_pod=multi)),
                          (SH.sp_rules(multi_pod=multi),
                           RS.sp_rules(multi_pod=multi)),
                          (SH.default_rules(fsdp=False),
                           RS.default_rules(fsdp=False))):
        for (path, ax), (_, t) in zip(_port_leaves(axes),
                                      _port_leaves(params)):
            rax, rshape = _at(raxes, path), _at(rshapes, path).shape
            stacked = len(rshape) - t.dim()
            for hf in (False, True):
                for got_rules, want_rules in ((rules.params, rrules.params),
                                              (rules.acts, rrules.acts)):
                    want = tuple(RS.spec_for(rax, rshape, want_rules,
                                             _Mesh(sizes), head_fallback=hf))
                    assert want[:stacked] == (None,) * len(want[:stacked])
                    got = SH.spec_for(ax, tuple(t.shape), got_rules, sizes,
                                      head_fallback=hf)
                    assert got == want[stacked:], (path, hf)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_specs_equal_the_reference(mesh):
    from repro.distributed import sharding as RS
    sizes = MESHES[mesh]
    multi = "pod" in sizes
    shapes = [(256, 4096, 2048), (32, 32768, 151936), (128, 1, 4096),
              (1, 524288, 32, 80), (128, 1, 20, 64), (64, 4096, 2, 128)]
    for rules, rrules in ((SH.default_rules(multi_pod=multi),
                           RS.default_rules(multi_pod=multi)),
                          (SH.sp_rules(multi_pod=multi),
                           RS.sp_rules(multi_pod=multi))):
        for ax in ACT_AXES:
            for shape in shapes:
                if len(shape) != len(ax):
                    continue
                for hf in (False, True):
                    want = tuple(RS.spec_for(ax, shape, rrules.acts,
                                             _Mesh(sizes), head_fallback=hf))
                    assert SH.spec_for(ax, shape, rules.acts, sizes,
                                       head_fallback=hf) == want


def test_rules_equal_the_reference():
    from repro.distributed import sharding as RS
    for kw in ({}, {"fsdp": False}, {"multi_pod": True}):
        for f in ("default_rules", "sp_rules"):
            got, want = getattr(SH, f)(**kw), getattr(RS, f)(**kw)
            assert got.params == want.params and got.acts == want.acts
    assert SH.FALLBACK_TO_MODEL == RS.FALLBACK_TO_MODEL


def test_placements_of_a_spec():
    """Specs become DTensor placements on a mesh of named dims (no
    process group: ``placements`` reads only the names)."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    assert SH.placements((), Mesh()) == (Replicate(),) * 3
    assert SH.placements((("pod", "data"), None, "model"), Mesh()) == (
        Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError):
        SH.placements((("data", "pod"),), Mesh())


# -- use_mesh_rules thread visibility (tests/test_distributed.py:226-265) --

def _one_device_mesh():
    return {"data": 1}


def test_use_mesh_rules_visible_across_threads():
    """constrain() must see the mesh the main thread entered on a worker
    thread, where a batch scheduler executes batches."""
    mesh, rules = _one_device_mesh(), SH.default_rules()
    seen = {}

    def worker():
        seen["state"] = SH.active_mesh_rules()
        seen["y"] = SH.constrain(torch.ones((4, 8)), ("batch", None))

    with SH.use_mesh_rules(mesh, rules):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["state"] == (mesh, rules)
    assert seen["y"].shape == (4, 8)
    assert SH.active_mesh_rules() is None          # context fully unwound


def test_use_mesh_rules_thread_local_override():
    """A thread may nest its own context over the process default; other
    threads keep seeing the default, and process_default=False keeps the
    override on its thread."""
    mesh, rules = _one_device_mesh(), SH.default_rules()
    override_rules = SH.default_rules(fsdp=False)
    seen = {}

    def worker():
        with SH.use_mesh_rules(mesh, override_rules, process_default=False):
            seen["inside"] = SH.active_mesh_rules()
        seen["after"] = SH.active_mesh_rules()

    with SH.use_mesh_rules(mesh, rules):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert SH.active_mesh_rules() == (mesh, rules)   # main thread intact
    assert seen["inside"] == (mesh, override_rules)
    assert seen["after"] == (mesh, rules)             # falls back to default


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_constrain_is_a_no_op_on_plain_tensors(arch):
    """Inside a mesh context, the plain-tensor forward, prefill and decode
    are bit for bit what they are outside one."""
    from repro_torch.serving import engine as E
    cfg = get_config(arch, smoke=True)
    params = M.init_params(cfg, 0, device="cpu")
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 12)))
    mem = None
    if cfg.family == "encdec":
        mem = torch.randn(2, cfg.n_frames, cfg.d_model,
                          generator=torch.Generator().manual_seed(0))

    def run():
        logits, cache = E.prefill(params, cfg, tok, 16, memory=mem)
        step, _ = E.decode_step(params, cfg, cache, tok[:, :1])
        return logits, step
    want = run()
    with SH.use_mesh_rules(MESHES["32x8"], SH.default_rules()):
        got = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_mamba_conv_state_owns_its_storage():
    """The prefill's conv state is the last K-1 inputs, copied: a view
    would keep each layer's whole input projection alive until the cache
    is stacked (the dry-run's peak found it)."""
    from repro_torch.models import ssm as S
    cfg = get_config("mamba2-2.7b", smoke=True)
    p = M.init_params(cfg, 0, device="cpu")["layers"][0]["mamba"]
    x = torch.randn(2, 40, cfg.d_model)
    _, st = S.apply_mamba(p, x, cfg, return_state=True)
    conv = st["conv"]
    assert conv.shape == (2, cfg.conv_width - 1, cfg.d_inner + 2 *
                          cfg.ssm_state)
    assert conv.untyped_storage().nbytes() == conv.numel() * \
        conv.element_size()


# -- MODEL_FLOPS ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(trees, arch):
    from repro.configs.base import SHAPE_CELLS as REF_CELLS
    from repro.configs.registry import get_config as ref_get
    from repro.roofline import analysis as RRA
    params, _, rshapes, _ = trees[arch]
    cfg, rcfg = get_config(arch), ref_get(arch)
    assert RA.count_active_params(cfg, params) == \
        RRA.count_active_params(rcfg, rshapes)
    for cell, rcell in zip(SHAPE_CELLS, REF_CELLS):
        assert RA.model_flops_for_cell(cfg, cell, params) == \
            RRA.model_flops_for_cell(rcfg, rcell, rshapes)


# -- input specs ------------------------------------------------------------

def _nbytes(t):
    return t.numel() * t.element_size()


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    import jax
    from repro.configs.base import SHAPE_CELLS as REF_CELLS
    from repro.configs.registry import get_config as ref_get
    from repro.configs.registry import input_specs as ref_specs
    cfg, rcfg = get_config(arch), ref_get(arch)
    for cell, rcell in zip(SHAPE_CELLS, REF_CELLS):
        got, want = input_specs(cfg, cell), ref_specs(rcfg, rcell)
        assert set(got) == set(want)
        for k in set(got) - {"cache"}:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape)
            if k in ("tokens", "token"):
                assert got[k].dtype == torch.int64     # the reference: int32
                assert str(want[k].dtype) == "int32"
            else:
                assert str(got[k].dtype).split(".")[-1] == \
                    str(want[k].dtype)
        if "cache" in got:
            flat = dict(_port_leaves(got["cache"]))
            rflat = {tuple(getattr(p, "key", p) for p in path): leaf
                     for path, leaf in
                     jax.tree_util.tree_flatten_with_path(want["cache"])[0]}
            assert set(flat) == set(rflat)
            for k, t in flat.items():
                assert tuple(t.shape) == tuple(rflat[k].shape), k
                assert str(t.dtype).split(".")[-1] == str(rflat[k].dtype)
            assert sum(_nbytes(t) for t in flat.values()) == sum(
                int(np.prod(x.shape)) * x.dtype.itemsize
                for x in rflat.values())


# -- Roofline ---------------------------------------------------------------

def test_roofline_terms_and_bottleneck():
    """The reference's synthetic case, with one rate per link: each
    axis's bytes take an eighth of a second on its link."""
    r = RA.Roofline(arch="a", cell="c", mesh="m", chips=256,
                    flops=256 * RA.PEAK_FLOPS,          # exactly 1s compute
                    hbm_bytes=256 * RA.HBM_BW * 0.5,    # 0.5s memory
                    coll_by_op={},
                    coll_by_axis={"model": RA.NVLINK_BW * 0.125,
                                  "data": RA.IB_BW * 0.125},   # 0.25s
                    model_flops=128 * RA.PEAK_FLOPS,
                    per_device_bytes=10 ** 9)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 0.5) < 1e-9
    assert abs(r.t_collective - 0.25) < 1e-9
    assert r.bottleneck == "compute"
    assert abs(r.mfu - 0.5) < 1e-9          # half the traced flops useful
    assert abs(r.useful_flops_frac - 0.5) < 1e-9
    row = r.row()
    assert row["coll_by_axis_mb"] == {"model": RA.NVLINK_BW * 0.125 / 1e6,
                                      "data": RA.IB_BW * 0.125 / 1e6}
    assert RA.LINK_BW == {"model": 450e9, "data": 50e9, "pod": 50e9}


def test_model_flops_moe_discounts_inactive_experts():
    from repro_torch.configs.base import SHAPE_BY_NAME
    cfg = get_config("granite-moe-3b-a800m", smoke=True)  # 8 experts top-2
    params = M.init_params(cfg, device="meta")
    total, active = RA.count_active_params(cfg, params)
    assert active < total
    cell = SHAPE_BY_NAME["train_4k"]
    assert RA.model_flops_for_cell(cfg, cell, params) == \
        6.0 * active * cell.global_batch * cell.seq_len


# -- perf variants ----------------------------------------------------------

VARIANTS = ["baseline", "mesh64x4", "mesh2x32x8", "remat_dots", "remat_none",
            "mb1", "mb8", "mb2gc", "grad_compress", "seqpar", "banded",
            "bq1024", "swa1024", "blockkv4096", "moebf16", "moegroup256",
            "remat_dots+mb8", "mesh64x4+seqpar", "banded+swa2048"]


@pytest.fixture(scope="module")
def ref_perf():
    """The reference's ``launch/perf.py``, imported after JAX has made its
    devices (its import sets ``XLA_FLAGS`` for a 512-device dry-run,
    which would reach a JAX started later in this process); the variable
    is restored."""
    import jax
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.perf as RP
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return RP


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("use_kernels", None)
    d.pop("use_pallas", None)
    return d


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ["starcoder2-7b", "granite-moe-3b-a800m"])
def test_variant_kwargs_equal_the_reference(ref_perf, arch, variant):
    from repro_torch.launch.perf import variant_kwargs
    got, want = variant_kwargs(variant, arch), ref_perf.variant_kwargs(
        variant, arch)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k == "cfg_override":
            assert _fields(g) == _fields(w)
        elif k == "tc":
            assert (g.microbatches, g.grad_compress) == \
                (w.microbatches, w.grad_compress)
        elif k == "rules":
            assert (g.params, g.acts) == (w.params, w.acts)
        else:
            assert g == w, k


def test_unknown_variant_raises():
    from repro_torch.launch.perf import variant_kwargs
    with pytest.raises(ValueError):
        variant_kwargs("nope", "qwen3-1.7b")
