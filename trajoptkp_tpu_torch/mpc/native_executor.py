"""ctypes bindings for the native real-time executor core
(`mpc/native/executor.cpp`; counterpart of `trajoptkp_tpu/mpc/
native_executor.py`).

Gives the async-MPC actor the runtime services of the reference's C++ sim
thread (its `src/main.cpp:425-744`): a lock-free latest-plan buffer and
absolute-deadline pacing.  The library is built at first use by
`g++ -O2 -shared -fPIC -std=c++17` into the port's gitignored build
directory (`kernels/_build/`), named by a digest of the source and the
flags as the kernels are (kernels/build.py), and loaded once.  A failed
build raises: there is no fallback to the Python buffer, which only an
explicit argument of `mpc/async_mpc.py:AsyncMPC` chooses.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

from ..kernels.build import BUILD_DIR

SRC = pathlib.Path(__file__).parent / "native" / "executor.cpp"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_LOCK = threading.Lock()


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"executor-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless it is there; raise if g++ fails."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent reader sees all or none
    return out


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.cb_create.restype = ctypes.c_void_p
    lib.cb_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cb_destroy.argtypes = [ctypes.c_void_p]
    lib.cb_publish.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    lib.cb_next.restype = ctypes.c_int
    lib.cb_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.cb_consumed_index.restype = ctypes.c_int
    lib.cb_consumed_index.argtypes = [ctypes.c_void_p]
    lib.cb_stat.restype = ctypes.c_uint64
    lib.cb_stat.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ticker_create.restype = ctypes.c_void_p
    lib.ticker_create.argtypes = [ctypes.c_double]
    lib.ticker_destroy.argtypes = [ctypes.c_void_p]
    lib.ticker_wait.restype = ctypes.c_double
    lib.ticker_wait.argtypes = [ctypes.c_void_p]
    lib.ticker_overruns.restype = ctypes.c_uint64
    lib.ticker_overruns.argtypes = [ctypes.c_void_p]
    lib.ticker_ticks.restype = ctypes.c_uint64
    lib.ticker_ticks.argtypes = [ctypes.c_void_p]
    return lib


def lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _load()
    return _LIB


class NativeControlBuffer:
    """Seqlock latest-plan buffer: the planner publishes, the actor pops
    without a lock."""

    def __init__(self, horizon: int, nu: int):
        self._lib = lib()
        self._h = self._lib.cb_create(horizon, nu)
        self.horizon = horizon
        self.nu = nu

    def publish(self, plan: np.ndarray, start_index: int = 1) -> None:
        plan = np.ascontiguousarray(plan, dtype=np.float64)
        if plan.shape != (self.horizon, self.nu):
            raise ValueError(f"plan has shape {plan.shape}, want "
                             f"{(self.horizon, self.nu)}")
        self._lib.cb_publish(
            self._h, plan.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            int(start_index))

    def next_control(self) -> Optional[np.ndarray]:
        out = np.empty(self.nu, dtype=np.float64)
        ok = self._lib.cb_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out if ok else None

    def consumed(self) -> int:
        return int(self._lib.cb_consumed_index(self._h))

    @property
    def stats(self) -> dict:
        return {
            "plans_published": int(self._lib.cb_stat(self._h, 0)),
            "controls_consumed": int(self._lib.cb_stat(self._h, 1)),
            "underruns": int(self._lib.cb_stat(self._h, 2)),
        }

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cb_destroy(self._h)
            self._h = None


class RtTicker:
    """Absolute-deadline pacing on CLOCK_MONOTONIC (the reference's
    relative-sleep compensation loop, `main.cpp:552-562`, without drift)."""

    def __init__(self, period_s: float):
        self._lib = lib()
        self._h = self._lib.ticker_create(float(period_s))

    def wait(self) -> float:
        """Sleep to the next deadline; returns the lateness in seconds, 0.0
        when on time."""
        return float(self._lib.ticker_wait(self._h))

    @property
    def overruns(self) -> int:
        return int(self._lib.ticker_overruns(self._h))

    @property
    def ticks(self) -> int:
        return int(self._lib.ticker_ticks(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ticker_destroy(self._h)
            self._h = None
