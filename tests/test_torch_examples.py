"""The port's examples (``examples/*_torch.py``) on the CPU at reduced
size, against the reference where the reference computes the same thing:

* quickstart's tables (K's shape and density, the strided-swap
  permutation, the 2:4 check, ``meta[0][:8]``) equal the reference's bit
  for bit, and every backend agrees with ``direct``;
* heat diffusion at 64² x 20 steps: every path's ``sum(u)`` within 1e-5
  (relative) of the reference's ``direct`` engine;
* stencil serving: every job checked against ``direct`` by the example;
* batched serving: three families' tokens;
* LM training over the host mesh, then a restart that resumes;
* an AST check: the five files import only the standard library,
  ``torch``, ``numpy`` and ``repro_torch``.
"""
from __future__ import annotations

import ast
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("quickstart", "heat_diffusion_2d", "serve_stencils",
         "serve_batched", "train_lm")
ALLOWED = {"torch", "numpy", "repro_torch"}


def _example(name: str):
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_no_jax_and_no_reference(name):
    tree = ast.parse((ROOT / "examples" / f"{name}_torch.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots - ALLOWED <= set(sys.stdlib_module_names), roots
    assert not roots & {"jax", "jaxlib", "repro"}


def test_quickstart_tables_equal_the_reference(capsys):
    from repro.core import kernel_matrix, make_stencil, sparsify_stencil_kernel
    from repro.core.sparsify import apply_col_perm, is_24_sparse
    got = _example("quickstart").main(["--device", "cpu", "--n", "32"])
    assert "quickstart OK" in capsys.readouterr().out
    row = make_stencil("box", 2, 3, seed=42).weights[3]
    K = kernel_matrix(row)
    sk = sparsify_stencil_kernel(row)
    assert got["K"].shape == K.shape and got["K"].dtype == K.dtype
    assert got["K"].tobytes() == np.asarray(K).tobytes()
    assert np.mean(got["K"] != 0) == np.mean(K != 0)
    assert np.array_equal(got["perm"], sk.perm)
    assert got["is_24"] == is_24_sparse(apply_col_perm(K, sk.perm)) is True
    assert tuple(got["values_shape"]) == tuple(sk.values.shape)
    assert np.asarray(got["meta0"]).tolist() == sk.meta[0][:8].tolist()
    scale = 1 + float(got["direct"].abs().max())
    assert max(got["errors"].values()) <= 3e-5 * scale


def test_heat_diffusion_sums_equal_the_reference_direct():
    import jax.numpy as jnp
    from repro.core.engine import StencilEngine
    from repro.core.stencil import StencilSpec
    n, steps = 64, 20
    got = _example("heat_diffusion_2d").main(
        ["--device", "cpu", "--n", str(n), "--steps", str(steps)])
    w = np.zeros((3, 3))
    w[0, 1] = w[2, 1] = w[1, 0] = w[1, 2] = 0.2
    w[1, 1] = 1 - 4 * 0.2
    u0 = np.zeros((n, n), np.float32)
    u0[n // 4:n // 2, n // 4:n // 2] = 100.0
    ref = StencilEngine(StencilSpec(shape="star", ndim=2, radius=1,
                                    weights=w), backend="direct")
    want = float(jnp.sum(ref.iterate(jnp.asarray(np.pad(u0, 1)), steps)))
    assert set(got) == {"direct", "gemm", "sptc", "cuda_sptc", "cuda_gemm",
                        "cuda_direct", "tuned"}
    for backend, row in got.items():
        assert abs(row["sum"] - want) <= 1e-5 * abs(want), backend
        assert row.get("max_err", 0.0) < 1e-2


def test_serve_stencils_checks_every_job(capsys):
    got = _example("serve_stencils").main(["--device", "cpu"])
    assert got["jobs"] == 8 * 6 and got["max_rel_err"] <= 3e-5
    assert got["metrics"]["overall"]["completed"] == 48
    assert "stencil serving OK" in capsys.readouterr().out


def test_serve_batched_generates_for_three_families(capsys):
    mod = _example("serve_batched")
    got = mod.main(["--device", "cpu"])
    assert set(got) == set(mod.ARCHS)
    for arch, toks in got.items():
        vocab = mod.get_config(arch, smoke=True).vocab
        assert tuple(toks.shape) == (4, 16) and toks.dtype == torch.int32
        assert 0 <= int(toks.min()) and int(toks.max()) < vocab
    out = capsys.readouterr().out
    assert "batched serving OK" in out and "family=ssm" in out


def test_train_lm_trains_and_resumes(tmp_path, capsys):
    mod = _example("train_lm")
    d = str(tmp_path / "run")
    st = mod.main(["--device", "cpu", "--steps", "4", "--ckpt-dir", d])
    out = capsys.readouterr().out
    assert int(st.opt.step) == 4 and "devices=1" in out
    st2 = mod.main(["--device", "cpu", "--steps", "4", "--ckpt-dir", d])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and " loss " not in out
    from repro_torch.models.nn import tree_leaves
    for a, b in zip(tree_leaves(st.tree()), tree_leaves(st2.tree())):
        assert torch.equal(a, b)
