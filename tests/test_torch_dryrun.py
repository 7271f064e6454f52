"""The port's fleet dry-run (``python -m repro_torch.launch.dryrun``) on
the CPU.

The CLI runs in a subprocess (its fake process group is the process's
default group), with ``--device cpu``, on the cells the reference's
``tests/test_dryrun.py`` runs, asserting what it asserts with the H100's
80 GB in place of the v5e's 16 GB: ``qwen3-1.7b x decode_32k`` on the
(32, 8) fleet and ``mamba2-2.7b x long_500k`` on the (2, 32, 8) one.  The
port is not held to the reference's dry-run outputs (its
``test_dryrun_single_cell_compiles`` fails).  Also: the sweep resumes from
its JSONL, ``launch.perf`` runs two variants, the modules import neither
JAX nor the reference, the one-card trace of a train step predicts the
FLOPs and argument bytes a real step on the CPU counts exactly and its
peak within 1 KB (smoke configs, the same counter),
:class:`DeviceCounter` counts a matmul, its bytes and live storage, a
fleet mesh refuses a process group it did not make and ``release`` leaves
that group alone, and a sharded Mamba2 conv with ``use_kernels`` goes
through the kernel's wrapper.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300                 # seconds per subprocess; each takes ~10 here


def _run(args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=TIMEOUT)


def test_dryrun_single_cell(tmp_path):
    out = tmp_path / "cell.jsonl"
    args = ["repro_torch.launch.dryrun", "--device", "cpu", "--arch",
            "qwen3-1.7b", "--cell", "decode_32k", "--out", str(out)]
    r = _run(args + ["--no-resume"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["ok"] and rec["mesh"] == "32x8" and rec["chips"] == 256
    # roofline terms present and sane
    assert rec["t_memory_s"] > 0 and rec["hlo_gflops"] > 0
    assert rec["per_device_gb"] < 80, "decode cell must fit H100 HBM"
    assert rec["arg_gb"] > 0 and rec["temp_gb"] >= 0
    assert set(rec["coll_by_axis_mb"]) <= {"data", "model"}
    # rerun: the cell is done, nothing is appended
    r = _run(args)
    assert r.returncode == 0 and "0/0 cells OK" in r.stdout, r.stderr[-2000:]
    assert len(out.read_text().splitlines()) == 1


def test_dryrun_multipod_cell(tmp_path):
    out = tmp_path / "cell.jsonl"
    r = _run(["repro_torch.launch.dryrun", "--device", "cpu", "--arch",
              "mamba2-2.7b", "--cell", "long_500k", "--multi-pod", "--out",
              str(out), "--no-resume"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["ok"] and rec["chips"] == 512 and rec["mesh"] == "2x32x8"
    # O(1) SSM state: the 500k-context decode cache must be tiny
    assert rec["per_device_gb"] < 2


def test_perf_variants(tmp_path):
    out = tmp_path / "perf.jsonl"
    r = _run(["repro_torch.launch.perf", "--device", "cpu", "--arch",
              "qwen3-1.7b", "--cell", "decode_32k", "--variant", "mesh64x4",
              "seqpar", "--out", str(out)])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["variant"] for x in recs] == ["mesh64x4", "seqpar"]
    assert [x["mesh"] for x in recs] == ["64x4/mesh64x4", "32x8/seqpar"]
    assert all(x["ok"] and x["chips"] == 256 for x in recs)


def test_modules_import_no_jax():
    code = ("import sys, repro_torch.launch.dryrun, repro_torch.launch.perf,"
            " repro_torch.launch.mesh, repro_torch.distributed.sharding\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\nassert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                       cwd=REPO, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m",
                                  "mamba2-2.7b", "llama-3.2-vision-11b"])
def test_one_card_trace_predicts_a_real_step(arch, tmp_path):
    """The check ``chip_smoke.py`` makes on the card, on the CPU at smoke
    size: a train cell traced on a (1, 1) fake mesh predicts the FLOPs and
    argument bytes that the same counter counts on one real step exactly,
    and its peak of live bytes within 1 KB."""
    code = f"""
import dataclasses
import json
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh as MS
from repro_torch.launch.dryrun import count_step, lower_cell
from repro_torch.training.train_step import TrainConfig
cfg = get_config({arch!r}, smoke=True).scaled(dtype="bfloat16", remat=True)
cell, tc = ShapeCell("train", "train", 32, 8), TrainConfig(microbatches=2)
r = lower_cell({arch!r}, cell, cfg_override=cfg, tc=tc,
               mesh_override=((1, 1), ("data", "model")), device="cpu")
MS.release()
c = count_step(cfg, cell, tc, device="cpu")
print(json.dumps([r["flops_perdev"], c.flops, r["arg_bytes"], c.arg_bytes,
                  r["peak_bytes"], c.peak, r["n_collectives"]]))
"""
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                       cwd=REPO, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-2000:]
    f, f_real, a, a_real, p, p_real, n = json.loads(
        r.stdout.strip().splitlines()[-1])
    assert f == f_real > 0
    assert a == a_real > 0
    assert abs(p - p_real) <= 1024 and p > a
    assert n == 0


def test_device_counter_on_plain_tensors():
    from repro_torch.launch.dryrun import DeviceCounter
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    c = DeviceCounter()
    c.hold_args((a, b))
    assert c.arg_bytes == (64 * 32 + 32 * 16) * 4
    with c:
        y = a @ b                                    # 64 x 16 float32
        z = torch.ones(1000)                         # 4000 bytes, freed
        del z
        w = y.t()                                    # a view: no bytes
    assert c.flops == 2 * 64 * 32 * 16
    assert c.dot_bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert c.peak == c.arg_bytes + 64 * 16 * 4 + 4000
    assert c.live == c.arg_bytes + 64 * 16 * 4
    assert c.n_collectives == 0 and w.shape == (16, 64)


def test_fake_mesh_needs_a_card_by_default():
    from repro_torch.launch import mesh as MS
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MS.make_production_mesh()
    assert not torch.distributed.is_initialized()


def test_host_mesh_alone_is_this_device():
    """Started without a process group, the host mesh is this device
    alone, over a group of one that ``release`` destroys."""
    code = ("import torch.distributed as dist\n"
            "from repro_torch.launch import mesh as MS\n"
            "m = MS.make_host_mesh('cpu')\n"
            "assert tuple(m.shape) == (1,) and m.mesh_dim_names == ('data',)\n"
            "MS.release()\nassert not dist.is_initialized()\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                       cwd=REPO, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-2000:]


def test_dryrun_leaves_a_callers_group_alone():
    """Under a process group the caller made, a fleet mesh raises and
    ``release`` leaves the group as it was."""
    code = ("import pytest, torch.distributed as dist\n"
            "from repro_torch.launch import mesh as MS\n"
            "dist.init_process_group('gloo', store=dist.HashStore(),\n"
            "                        rank=0, world_size=1)\n"
            "with pytest.raises(RuntimeError, match='process of its own'):\n"
            "    MS.fake_mesh((2,), ('data',), 'cpu')\n"
            "MS.release()\n"
            "assert dist.is_initialized() and dist.get_backend() == 'gloo'\n"
            "dist.destroy_process_group()\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                       cwd=REPO, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-2000:]


def test_sharded_conv_reaches_the_kernel_wrapper(monkeypatch):
    """A DTensor Mamba2 conv with ``use_kernels`` runs each shard through
    the kernel's wrapper (its plain version on the CPU) and gives the
    plain result; on meta shards, as a dry-run with ``use_kernels`` has
    them, the wrapper raises."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import NamedSharding, distribute
    from repro_torch.kernels.conv1d.ops import conv1d_causal
    from repro_torch.launch import mesh as MS
    from repro_torch.models import ssm as SSM
    calls = []

    def spy(x, w):
        calls.append(tuple(x.shape))
        return conv1d_causal(x, w)
    monkeypatch.setattr(SSM, "conv1d_causal", spy)
    cfg = get_config("mamba2-2.7b", smoke=True)
    ch = cfg.d_inner + 2 * cfg.ssm_state
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, ch, generator=gen)
    p = {"conv_w": torch.randn(cfg.conv_width, ch, generator=gen),
         "conv_b": torch.randn(ch, generator=gen)}
    want = SSM._conv(p, x, cfg)
    assert not calls
    kcfg = dataclasses.replace(cfg, use_kernels=True)
    mesh = MS.fake_mesh((1,), ("data",), "cpu")
    try:
        with implicit_replication():
            got = SSM._conv(p, distribute(x, NamedSharding(mesh, ("data",))),
                            kcfg)
            assert calls == [(2, 8, ch)]
            torch.testing.assert_close(got.full_tensor(), want, rtol=0,
                                       atol=1e-6)
            meta = distribute(x.to("meta"), NamedSharding(mesh, ("data",)))
            pm = {k: v.to("meta") for k, v in p.items()}
            with pytest.raises(ValueError, match="no kernel for device meta"):
                SSM._conv(pm, meta, kcfg)
    finally:
        MS.release()
    assert not torch.distributed.is_initialized()
