"""Hand-written CUDA kernels for Hopper (``csrc/``) with their plain torch
versions: the fused SpTC application, the windows GEMM and the direct
stencil.  Built with ``nvcc`` on first use (``build.py``)."""
