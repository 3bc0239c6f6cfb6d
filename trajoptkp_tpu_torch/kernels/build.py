"""Build the CUDA kernels at first use and load them with ctypes.

Each `csrc/<source>.cu` has a plain C interface (no PyTorch headers).  Each
instance of it (a model topology, or a backward-pass size, listed in
`csrc/instances.cuh`) is compiled by its own `nvcc` for sm_90a, naming the
instance with `-DTRAJOPT_ONLY`, into `_build/<source>-<instance>-<hash>.so`
(the keypoint kernels take their sizes at run time and are built once, as
the instance "generic");
the compilers run in parallel, so a large instance (the backward pass at
nx 20, nu 7) no longer holds up the others of its source.  The hash covers
the sources, the flags and the instance, so an edited source rebuilds and an
unchanged one loads the library already there.  `torch.utils.cpp_extension`
is imported only here, inside the build, to find the CUDA toolkit; nothing
at import time touches it, so machines without `nvcc` can import the
package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
# sources built per model instance, and the backward pass per (nx, nu)
MODEL_SOURCES = ("ad_jacobian", "rollout", "linesearch", "fd_jacobian",
                 "cost_expansion", "mpc_apply")
# the libraries whose nvcc runs longest start first: the dual steps over the
# walker's 128 and push_ncl's 42 constraint rows, the largest backward passes
SLOWEST = (("ad_jacobian", "walker"), ("ad_jacobian", "push_ncl"),
           ("backward", "nx20_nu7"), ("backward", "nx18_nu6"),
           ("ad_jacobian", "reaching"))
# sources built once for every model
GENERIC_SOURCES = ("keypoints", "kp_interp")
# -fmad=false: no contraction of a*b+c into FMA, so the kernels round as
# their plain PyTorch twins do (csrc/step.cuh)
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
         "-Xptxas=-v")

_LIBS: dict = {}
_LOAD_LOCK = threading.Lock()   # the async MPC loads from two threads


@functools.lru_cache(maxsize=None)
def instance_names() -> tuple:
    """(model tags, backward-pass names "nx<NX>_nu<NU>") of instances.cuh."""
    text = (CSRC / "instances.cuh").read_text()
    models = tuple(m for m in re.findall(r"#define TRAJOPT_MODEL_(\w+)\(X\)",
                                         text) if m != "INSTANCES")
    bps = tuple(re.findall(r"#define TRAJOPT_BP_(nx\d+_nu\d+)\(B\)", text))
    return models, bps


def libraries() -> tuple:
    """Every (source, instance) library the kernels are built into."""
    models, bps = instance_names()
    return (tuple((s, m) for s in MODEL_SOURCES for m in models)
            + tuple(("backward", b) for b in bps)
            + tuple((s, "generic") for s in GENERIC_SOURCES))


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if not CUDA_HOME:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset and no "
                           "nvcc on PATH); the kernels cannot be built")
    path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}")
    return path


def _only(source: str, instance: str) -> tuple:
    if source in GENERIC_SOURCES:
        return ()
    kind = "BP" if source == "backward" else "MODEL"
    return (f"-DTRAJOPT_ONLY=TRAJOPT_{kind}_{instance}",)


def _digest(source: str, instance: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS + _only(source, instance)).encode())
    for p in [CSRC / f"{source}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str, instance: str) -> pathlib.Path:
    return BUILD_DIR / f"{source}-{instance}-{_digest(source, instance)}.so"


def build(libs=None) -> dict:
    """Compile every (source, instance) library in `libs` (default: all)
    that is missing, all nvcc started together.

    Returns {"source-instance": compiler output} for the libraries compiled
    here (ptxas prints each kernel's registers, stack frame and spills, and
    the last line the seconds until that nvcc was done)."""
    libs = libraries() if libs is None else tuple(libs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = sorted((lib for lib in libs if not library_path(*lib).exists()),
                  key=lambda lib: SLOWEST.index(lib) if lib in SLOWEST
                  else len(SLOWEST))
    if not todo:
        return {}
    cc = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for source, instance in todo:
        out = library_path(source, instance)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cc, *FLAGS, *_only(source, instance), "-I", str(CSRC), "-o",
               str(tmp), str(CSRC / f"{source}.cu")]
        procs[f"{source}-{instance}"] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True), tmp, out)
    # drain every compiler's output as it comes, so that none blocks on a
    # full pipe, and note when each one finished
    texts = {name: [] for name in procs}
    done_s = {}

    def drain(name, proc):
        for line in proc.stdout:
            texts[name].append(line)
        proc.wait()
        done_s[name] = time.perf_counter() - t0

    readers = [threading.Thread(target=drain, args=(name, proc))
               for name, (proc, _, _) in procs.items()]
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        # the compilers run side by side: seconds until this one was done
        logs[name] = "".join(texts[name]) + f"nvcc {name}: done after " \
            f"{done_s[name]:.1f} s\n"
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)  # atomic: a concurrent reader sees all or none
    if failed:
        msg = "\n".join(f"--- {n}\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msg}")
    return logs


def load(source: str, instance: str) -> ctypes.CDLL:
    """The loaded library of one instance of a kernel source, built first
    if needed."""
    key = (source, instance)
    lib = _LIBS.get(key)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(key)
            if lib is None:
                path = library_path(source, instance)
                if not path.exists():
                    build((key,))
                lib = _LIBS[key] = ctypes.CDLL(str(path))
    return lib


def build_all_timed() -> tuple:
    """(seconds, logs): build every kernel library, as a set-up step."""
    t0 = time.perf_counter()
    logs = build()
    for lib in libraries():
        load(*lib)
    return time.perf_counter() - t0, logs


def error_string(lib: ctypes.CDLL, err: int) -> str:
    fn = lib.trajopt_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()
