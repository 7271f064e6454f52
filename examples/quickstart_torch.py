"""Quickstart on the PyTorch/CUDA port: the paper's technique in ~60 lines.

A Box-2D3R stencil is transformed into banded kernel matrices, strided-swap
permuted into 2:4 structured sparsity, encoded into the SpTC compressed
(values, metadata) form, and executed through every backend: the plain
torch ``gemm`` and ``sptc`` paths and the hand-written CUDA kernels
(``cuda_sptc``: ``mma.sp`` on the sparse tensor cores, ``cuda_gemm``,
``cuda_direct``), each against the pointwise ``direct`` oracle.  The
PyTorch counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (apply_stencil, kernel_matrix, make_stencil,
                              sparsify_stencil_kernel)
from repro_torch.core.sparsify import apply_col_perm, is_24_sparse
from repro_torch.device import resolve_device

BACKENDS = ("gemm", "sptc", "cuda_sptc", "cuda_gemm", "cuda_direct")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--n", type=int, default=128, help="grid side")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a Box-2D stencil of radius 3 (the paper's headline configuration)
    spec = make_stencil("box", 2, 3, seed=42)
    print(f"stencil: {spec.name}, {spec.taps} taps")

    # 2. one row of the kernel -> banded matrix K (L x 2L), L = 2r+2
    row = spec.weights[3]                       # center row, shape (7,)
    K = kernel_matrix(row)                      # (8, 16) band, 50% dense
    print(f"kernel matrix: {K.shape}, density {np.mean(K != 0):.2f}")

    # 3. strided swap -> valid 2:4 pattern -> compressed (values, metadata)
    sk = sparsify_stencil_kernel(row)
    Kp = apply_col_perm(K, sk.perm)
    print(f"2:4 sparse after swap: {is_24_sparse(Kp)}")
    print(f"compressed operand: {sk.values.shape} (was {K.shape}) — "
          f"half the reduction width")
    print(f"metadata sample (row 0): {sk.meta[0][:8].tolist()}")

    # 4. execute the full 2-D stencil through each backend
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(args.n + 6, args.n + 6)).astype(
        np.float32), device=device)
    y_direct = apply_stencil(spec, x, backend="direct")    # pointwise oracle
    errors = {}
    for backend in BACKENDS:
        y = apply_stencil(spec, x, backend=backend)
        errors[backend] = float((y - y_direct).abs().max())
        print(f"{backend:11s} vs direct: max|err| = {errors[backend]:.2e}")
    print("quickstart OK")
    return {"K": K, "is_24": is_24_sparse(Kp), "perm": sk.perm,
            "values_shape": sk.values.shape, "meta0": sk.meta[0][:8],
            "errors": errors, "direct": y_direct}


if __name__ == "__main__":
    main()
