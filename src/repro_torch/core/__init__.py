"""Core: the paper's contribution — stencil -> 2:4-sparse GEMM transform."""
from repro_torch.core.stencil import (PAPER_SUITE, StencilSpec, make_stencil,
                                      paper_suite, star_mask)
from repro_torch.core.transform import (decompose_rows, default_l,
                                        kernel_matrix, lower_spec)
from repro_torch.core.sparsify import (Sparse24, SparseStencilKernel,
                                       decode_24, encode_24, is_24_sparse,
                                       sparsify_matrices,
                                       sparsify_stencil_kernel,
                                       strided_swap_perm)
from repro_torch.core.ir import BACKENDS, LoweredPlan
from repro_torch.core.engine import (StencilEngine, apply_1d, apply_sptc_v1,
                                     apply_stencil, tile_windows)
from repro_torch.core.convert import coefficients_from_array, spec_from_arrays
from repro_torch.core import sptc

__all__ = [
    "PAPER_SUITE", "StencilSpec", "make_stencil", "paper_suite", "star_mask",
    "kernel_matrix", "default_l", "decompose_rows", "lower_spec", "Sparse24",
    "SparseStencilKernel", "encode_24", "decode_24", "is_24_sparse",
    "strided_swap_perm", "sparsify_matrices", "sparsify_stencil_kernel",
    "BACKENDS", "LoweredPlan", "StencilEngine", "apply_stencil", "apply_1d",
    "apply_sptc_v1", "tile_windows", "coefficients_from_array", "spec_from_arrays", "sptc",
]
