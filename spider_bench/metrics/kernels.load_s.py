"""kernels.load_s: seconds of the first call of repro_torch's kernel
library loader (``kernels/build.py::library``): the nvcc build where the
library for the sources was not built yet, and the load.

None where the library was not loaded (a run on the CPU) or the program
keeps no such counter."""
from repro_torch.kernels.build import library


def read(run):
    return getattr(library, "seconds", None)
