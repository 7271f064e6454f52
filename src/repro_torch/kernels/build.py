"""Build the CUDA sources in ``csrc/`` into one shared library and load it.

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together) and the objects are
linked into one library with a plain C interface, loaded with ``ctypes``.
The library's name carries a hash of the sources and flags, so a changed
source builds anew and an unchanged one is reused.  It is written under
``build/`` at the repository root (listed in ``.gitignore``) under a
temporary name and moved into place with ``os.replace``, so concurrent
builds never load a half-written file.

Nothing here runs at import time: :func:`library` builds on first use, and
keeps that first call's seconds (the build, if any, and the load) in
``library.seconds`` (``None`` until then).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: dtype codes of the C interface (csrc/common.cuh): the storage types
#: every kernel takes
DTYPE_CODES: Dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}
#: shared memory a kernel may stage per block without opting in to more
SMEM_LIMIT = 48 * 1024
#: shared memory a block may take on the H100 once it opts in (227 KB)
SMEM_OPT_IN = 232_448

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int

#: argument types of every exported function; sizes and strides are int64
#: (an untyped Python int would be cut to 32 bits), pointers and the stream
#: are void pointers
SIGNATURES: Dict[str, List[type]] = {
    "spider_sptc_fused": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                          _I, _I, _P],
    "spider_sptc_rows2d": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                           _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I,
                           _P],
    "spider_sptc_star2d": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                           _I64, _I64, _I64, _I64, _I64, _I, _I, _P],
    "spider_windows_gemm": [_P, _P, _P, _I64, _I64, _I64, _I64, _I, _P],
    "spider_stencil2d": [_P, _P, _P, _I64, _I64, _I, _I64, _I64, _I64, _I64,
                         _I64, _I64, _I64, _I, _P],
    "spider_sptc_spmm": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                         _I, _P],
    "spider_conv1d_causal": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                             _I, _P],
}


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Path of the library built from the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libspider_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "repro_torch CUDA kernels are built from csrc/ with nvcc for sm_90a")


def build() -> str:
    """Compile the sources unless the library for them exists.

    Returns the compiler's output (ptxas register and shared-memory
    report), empty when the library was already built.  Raises
    ``RuntimeError`` with the output of any ``nvcc`` that fails.
    """
    out = library_path()
    if out.exists():
        return ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [(src, obj, p.communicate()[0], p.returncode)
                for src, obj, p in procs]
        failed = [f"nvcc failed on {src.name}:\n{log}"
                  for src, _, log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib), *(str(o) for _, o, _, _ in logs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib, out)
    return "".join(f"[{src.name}]\n{log}" for src, _, log, _ in logs)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    t0 = time.perf_counter()
    build()
    lib = ctypes.CDLL(str(library_path()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.spider_error_string.argtypes = [ctypes.c_int]
    lib.spider_error_string.restype = ctypes.c_char_p
    library.seconds = time.perf_counter() - t0    # type: ignore[attr-defined]
    return lib


library.seconds = None    # type: ignore[attr-defined]


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if status != 0:
        msg = library().spider_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def stream_ptr(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
