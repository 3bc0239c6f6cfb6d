"""Build the CUDA kernels at first use and load them with ctypes.

Each `csrc/<source>.cu` has a plain C interface (no PyTorch headers).  Each
instance of it (a model topology, or a backward-pass size, listed in
`csrc/instances.cuh`) is compiled by its own `nvcc` for sm_90a, naming the
instance with `-DTRAJOPT_ONLY`, into `_build/<source>-<instance>-<hash>.so`
(the keypoint kernels take their sizes at run time and are built once, as
the instance "generic");
the compilers run in parallel, so a large instance (the dual step at
push_lcl) does not hold up the others of its source.  The hash covers
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

from . import topology

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
# sources built per model instance, and the backward pass per (nx, nu)
MODEL_SOURCES = ("ad_jacobian", "rollout", "linesearch", "fd_jacobian",
                 "cost_expansion", "mpc_apply")
# sources that run the step alone and read no residual: built once for
# instances whose keys differ in the residual only (`step_shared`)
STEP_SOURCES = ("ad_jacobian", "fd_jacobian")
# the libraries whose nvcc runs longest start first: the dual steps over
# push_lcl's 114, the walker's 128, box_sweep's 50 and push_ncl's 42
# constraint rows (each with its primal pass), then push_lcl's rolled
# steps (the backward passes and the line search, whose threads stride
# over entries, rows and dofs at run time, come after these)
SLOWEST = (("ad_jacobian", "push_lcl"), ("ad_jacobian", "walker"),
           ("ad_jacobian", "box_sweep"), ("ad_jacobian", "push_ncl"),
           ("fd_jacobian", "push_lcl"), ("rollout", "push_lcl"),
           ("ad_jacobian", "reaching"))
# libraries no path of chip_smoke.py's default run launches, built at their
# first launch instead of with the rest (the build is CPU-bound: every nvcc
# at once on the card's 8 cores; `chip_smoke.py --deep` builds them with
# the rest): K8 runs in the walker's and acrobot's MPC alone, and no
# pentabot path takes central FD
LAZY = tuple(("mpc_apply", m) for m in ("pentabot", "reaching", "push_ncl",
                                         "box_sweep", "threeD_push",
                                         "push_lcl")) + (
    ("fd_jacobian", "pentabot"),)
# past this many dofs (the model's nv) a library's loops over dofs and
# rows run rolled; below it they stay unrolled, because rolled the
# one-thread step's kernels run 2.7-5.6x slower (K3, K4 and K5ad at
# push_ncl and box_sweep on an H100, `bench_kernels.py --rolled`;
# PERF.md).  The backward pass and the line search (UNROLLED_SOURCES) are
# never rolled: their threads stride over entries, rows and dofs at run
# time and only inner sums over compile-time sizes are unrolled
# (csrc/backward.cu, csrc/warp_step.cuh).
ROLL_NV = 15
UNROLLED_SOURCES = ("backward", "linesearch")
# build the backward pass with its phase marks (TRAJOPT_BP_MARKS,
# csrc/backward.cu; `bench_kernels.py --backward --marks`): a library of
# its own, the marks' cost in every call
BP_MARKS = False
# build the line search with the cooperative step's phase marks
# (TRAJOPT_WARP_MARKS, csrc/warp_step.cuh; `bench_kernels.py --marks`)
WARP_MARKS = False
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


@functools.lru_cache(maxsize=None)
def instance_tables() -> dict:
    """model tag -> its topology.Topology, from instances.cuh (read once)."""
    return topology.parse((CSRC / "instances.cuh").read_text())


@functools.lru_cache(maxsize=None)
def step_shared() -> dict:
    """model tag -> the tag whose step-only libraries (STEP_SOURCES) it
    uses: the first instance whose tables equal its own but for the
    residual (RES, RESARGS); box_sweep's for threeD_push."""
    out, first = {}, {}
    for tag, topo in instance_tables().items():
        out[tag] = first.setdefault(topo.step_only(), tag)
    return out


def rolled(source: str, instance: str) -> bool:
    """Whether a library is built with TRAJOPT_ROLL_LOOPS: the model
    instances past ROLL_NV dofs (their loops over dofs and rows unrolled
    whole would keep nvcc for tens of minutes; rolled, each iteration does
    the same operations in the same order), but for UNROLLED_SOURCES."""
    if source in GENERIC_SOURCES or source in UNROLLED_SOURCES:
        return False
    return instance_tables()[instance].NV > ROLL_NV


def libraries(lazy: bool = False) -> tuple:
    """Every (source, instance) library the kernels are built into, LAZY's
    with `lazy`."""
    models, bps = instance_names()
    shared = step_shared()
    return (tuple((s, m) for s in MODEL_SOURCES for m in models
                  if (s not in STEP_SOURCES or shared.get(m, m) == m)
                  and (lazy or (s, m) not in LAZY))
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
    roll = ("-DTRAJOPT_ROLL_LOOPS",) if rolled(source, instance) else ()
    marks = (("-DTRAJOPT_BP_MARKS",) if BP_MARKS and source == "backward"
             else ("-DTRAJOPT_WARP_MARKS",) if WARP_MARKS
             and source == "linesearch" else ())
    return (f"-DTRAJOPT_ONLY=TRAJOPT_{kind}_{instance}",) + roll + marks


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
    if needed (cached with its flags: ROLL_NV, BP_MARKS and WARP_MARKS
    name other libraries)."""
    key = (source, instance, _only(source, instance))
    lib = _LIBS.get(key)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(key)
            if lib is None:
                path = library_path(source, instance)
                if not path.exists():
                    build(((source, instance),))
                lib = _LIBS[key] = ctypes.CDLL(str(path))
    return lib


def build_all_timed(lazy: bool = False) -> tuple:
    """(seconds, logs): build every kernel library (LAZY's with `lazy`), as
    a set-up step."""
    t0 = time.perf_counter()
    logs = build(libraries(lazy))
    for lib in libraries(lazy):
        load(*lib)
    return time.perf_counter() - t0, logs


def error_string(lib: ctypes.CDLL, err: int) -> str:
    fn = lib.trajopt_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()
