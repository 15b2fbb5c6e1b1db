"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each source ``csrc/<name>.cu`` is compiled on its own into a shared library
with a plain C interface, which the kernel's wrapper loads with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

The libraries go to ``sara_tpu_torch/_build/`` (listed in ``.gitignore``).
A library's file name carries a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing is compiled when a
module is imported: the first launch of a kernel builds it, or a caller
builds several at once with :func:`build`, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# nvcc's output per kernel built in this process (ptxas reports registers,
# shared memory and spills for each kernel).
BUILD_LOGS: dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under the CUDA toolkit torch finds."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or under CUDA_HOME)")


def kernel_names() -> list[str]:
    """Every kernel source in csrc/, by name."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile the named kernels that are not built yet, all in parallel.

    Returns the library path of each name. Raises RuntimeError, with the
    compiler's output, if any compilation fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    running = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp)
    failed = []
    for name, (proc, tmp) in running.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]))
        _LIBS[name] = lib
    return lib
