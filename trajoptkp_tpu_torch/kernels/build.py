"""Build the CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers) and is
compiled by its own `nvcc` for sm_90a into `_build/<name>-<hash>.so`; the
compilers run in parallel.  The hash covers the
sources and flags, so an edited source rebuilds and an unchanged one loads
the library already there.  `torch.utils.cpp_extension` is imported only
here, inside the build, to find the CUDA toolkit; nothing at import time
touches it, so machines without `nvcc` can import the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import time

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
SOURCES = ("rollout", "linesearch", "fd_jacobian", "backward")
# -fmad=false: no contraction of a*b+c into FMA, so the kernels round as
# their plain PyTorch twins do (csrc/step.cuh)
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
         "-Xptxas=-v")

_LIBS: dict = {}


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if not CUDA_HOME:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset and no "
                           "nvcc on PATH); the kernels cannot be built")
    path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names=SOURCES) -> dict:
    """Compile every library in `names` that is missing, in parallel.

    Returns {name: compiler output} for the libraries compiled here (ptxas
    prints each kernel's registers, shared memory and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    cc = nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cc, *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    t0 = time.perf_counter()
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        # the compilers run side by side: seconds until this one was done
        logs[name] = text + f"nvcc {name}: done after " \
            f"{time.perf_counter() - t0:.1f} s\n"
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)  # atomic: a concurrent reader sees all or none
    if failed:
        msg = "\n".join(f"--- {n}\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msg}")
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def build_all_timed() -> tuple:
    """(seconds, logs): build every kernel library, as a set-up step."""
    t0 = time.perf_counter()
    logs = build(SOURCES)
    for name in SOURCES:
        load(name)
    return time.perf_counter() - t0, logs


def error_string(err: int) -> str:
    lib = load(SOURCES[0])
    fn = lib.trajopt_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()
