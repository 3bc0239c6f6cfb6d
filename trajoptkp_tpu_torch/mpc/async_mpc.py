"""Asynchronous MPC: a planner thread re-optimises while a real-time actor
applies the planned controls (counterpart of
`trajoptkp_tpu/mpc/async_mpc.py`).

The reference's AsyncMPC (its `src/main.cpp:425-744`): the planner
re-optimises from the actor's latest state, one iLQR iteration per plan,
while the actor applies buffered controls at the model timestep.

- The planner (`_planner_loop`) shifts out the controls the actor consumed
  and pads with the last (`main.cpp:663-669`), runs `solver/ilqr.py:
  optimise` at max_iterations = min_iterations = 1 (the counterpart the
  port keeps of JAX's fused one-iteration solve, as `mpc/sync.py:
  make_sync_mpc` does) and installs the new plan at a start index set by
  `resync_mode`: "fixed1" (the reference's final choice, `main.cpp:707`),
  "opt_time" (the replan's latency in actor ticks) or "best_match" (the
  nearest planned state to the actor's current one, L1 over qpos and qvel,
  `main.cpp:687-707`).
- The actor (`_actor_step`) pops the next control, or holds gravity
  compensation when the plan is used up (`main.cpp:498-509`), adds
  Gaussian noise of 5% of each control's range (`main.cpp:489-496`) drawn
  from `np.random.default_rng(seed)` as JAX does, clips and steps.

On the card the actor's step is kernel K3 at H = 1, B = 1 (`ops.rollout`)
and its gravity hold `ops.fk_bias` (qfrc_bias at each actuator's dof over
its gear, `mpc/sync.py:gravity_compensation_ctrl`), both on a CUDA stream
of the actor's own, which it alone synchronises; the planner's kernels run
on a second stream, so an actor step never queues behind a replan.  Each
replan is timed by a CUDA event pair on the planner's stream and a
synchronize (on the CPU by the host clock).

The plan buffer is the native seqlock buffer (`mpc/native_executor.py`),
whose build failure raises; `buffer="python"` picks the lock-based
`ControlBuffer`, for tests.  Real-time pacing is the native absolute-
deadline ticker, created when the first plan is in (a real-time episode
needs the native buffer), and the interpreter's GIL switch interval is cut
to REALTIME_SWITCH_INTERVAL_S for the episode.  An
exception in the planner thread stops the episode and `run()` raises it;
JAX's daemon thread swallows it and the actor holds gravity compensation
to the end.

Recorded per episode: the replans' device ms (`replan_times_ms`) and host
ms, each plan's cost reduction by the planner's iteration, the controls the
actor took from each plan, the gravity holds (buffer underruns), the
ticker's overruns and the largest lateness.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..dynamics.model import Data
from ..kernels import ops
from ..solver.ilqr import ILQRConfig, optimise
from ..tasks.base import Task, control_limits
from .sync import gravity_compensation_ctrl

RESYNC_MODES = ("fixed1", "opt_time", "best_match")
# Python hands the GIL to a waiting thread once per switch interval (5 ms by
# default, more than half a 125 Hz tick): a real-time episode shortens it
# while it runs, so the actor takes the GIL back from the planner's host
# loop within this many seconds
REALTIME_SWITCH_INTERVAL_S = 2e-4


@dataclass
class ControlBuffer:
    """The mutex-guarded planner -> actor hand-off (`main.cpp:55-81,
    709-720`)."""

    lock: threading.Lock = field(default_factory=threading.Lock)
    controls: Optional[np.ndarray] = None   # (H, nu)
    index: int = 0

    def install(self, controls, index):
        with self.lock:
            self.controls = controls
            self.index = index

    def next_control(self):
        with self.lock:
            if self.controls is None or self.index >= len(self.controls):
                return None
            u = self.controls[self.index]
            self.index += 1
            return u

    def consumed(self):
        with self.lock:
            return self.index

    def has_plan(self):
        with self.lock:
            return self.controls is not None


class _NativeBufferAdapter:
    """NativeControlBuffer behind the ControlBuffer interface."""

    def __init__(self, native):
        self.native = native

    def install(self, controls, index):
        self.native.publish(np.asarray(controls, dtype=np.float64), index)

    def next_control(self):
        return self.native.next_control()

    def consumed(self):
        return self.native.consumed()

    def has_plan(self):
        return self.native.stats["plans_published"] > 0


def best_match_index(qpos_plan, qvel_plan, qpos, qvel, horizon: int) -> int:
    """The plan step among the first horizon - 1 whose (qpos, qvel) is
    nearest, L1, to the current (qpos, qvel) (`main.cpp:687-707`)."""
    X_old = np.concatenate([qpos_plan, qvel_plan], axis=1)
    cur = np.concatenate([qpos, qvel])
    return int(np.argmin(np.abs(X_old[:horizon - 1] - cur[None]).sum(1)))


class AsyncMPC:
    """Planner / actor pair for one task instance."""

    def __init__(self, task: Task, cfg: ILQRConfig, horizon: int,
                 noise_pct: float = 5.0, realtime: bool = False,
                 seed: int = 0, resync_mode: str = "fixed1",
                 buffer: str = "native"):
        if resync_mode not in RESYNC_MODES:
            raise ValueError(f"resync_mode {resync_mode!r}; known: "
                             f"{RESYNC_MODES}")
        if buffer not in ("native", "python"):
            raise ValueError(f"buffer {buffer!r}: 'native' or 'python'")
        if realtime and buffer != "native":
            raise ValueError("a real-time episode is paced by the native "
                             "ticker: it needs buffer='native'")
        model = task.model
        self.task = task
        self.model = model
        self.horizon = horizon
        self.realtime = realtime
        self.resync_mode = resync_mode
        self.dt = float(model.timestep)
        self.cfg = dataclasses.replace(cfg, max_iterations=1,
                                       min_iterations=1)
        self._f64 = dict(dtype=model.dtype, device=model.device)

        limits = control_limits(task).cpu().numpy()
        self._limits = limits
        width = limits[:, 1] - limits[:, 0]
        # unlimited actuators have infinite range: no range-scaled noise
        width = np.where(np.isfinite(width), width, 0.0)
        self._noise_std = width / 100.0 * noise_pct
        self._rng = np.random.default_rng(seed)

        self._native = buffer == "native"
        if self._native:
            from .native_executor import NativeControlBuffer
            self.buffer = _NativeBufferAdapter(
                NativeControlBuffer(horizon, model.nu))
        else:
            self.buffer = ControlBuffer()
        self._cuda = model.device.type == "cuda"
        if self._cuda:
            self._plan_stream = torch.cuda.Stream(model.device)
            self._act_stream = torch.cuda.Stream(model.device)
            # the constants both threads read are made here, on the
            # default stream, and complete before either stream runs
            ops.kernel_args(task, model.device)
        self._targets = task.residual_targets[:, None].contiguous()
        if self._cuda:
            torch.cuda.synchronize(model.device)
        self._stop = threading.Event()
        self._state_lock = threading.Lock()
        self._qpos = task.qpos_start.cpu().numpy().astype(np.float64)
        self._qvel = task.qvel_start.cpu().numpy().astype(np.float64)
        self.error: Optional[BaseException] = None
        self.replan_times_ms: list = []      # device time (host on the CPU)
        self.replan_host_ms: list = []
        self.consumed_per_plan: list = []    # controls taken from each plan
        # 1 - the plan's cost after the planner's iteration over its cost
        # before: 0 when the line search kept the shifted plan
        self.plan_cost_reduction: list = []
        self.holds = 0                       # gravity holds: buffer underruns
        self.overruns = 0                    # actor ticks past their deadline
        self.max_lateness_s = 0.0
        self.applied_controls: list = []
        self.visited_qpos: list = []
        self.visited_qvel: list = []

    def _on(self, stream):
        return (torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext())

    # ----- planner ---------------------------------------------------------

    def replan(self, qpos, qvel, U, plain=False):
        """One planner step: `optimise` at one iteration from (qpos, qvel)
        with the controls U (H, nu) (numpy) -> (Trajectory, ILQRStats), as
        `optimise` returns them.  `plain` as in `solver/lanes.py:
        solve_lanes`."""
        return optimise(self.task, qpos, qvel, U, self.cfg, plain=plain)

    def _planner_loop(self, U_init):
        try:
            with self._on(self._plan_stream if self._cuda else None):
                self._plan(np.asarray(U_init, dtype=np.float64))
        except Exception as e:  # noqa: BLE001 -- run() raises it
            self.error = e
            self._stop.set()

    def _plan(self, U):
        H = self.horizon
        stream = self._plan_stream if self._cuda else None
        start_idx = None
        while not self._stop.is_set():
            with self._state_lock:
                qpos = self._qpos.copy()
                qvel = self._qvel.copy()
            consumed = self.buffer.consumed()
            # shift the consumed controls out, pad with the last
            if 0 < consumed < len(U):
                U = np.concatenate([U[consumed:],
                                    np.tile(U[-1:], (consumed, 1))])
            t0 = time.perf_counter()
            if stream is not None:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record(stream)
            traj, st = self.replan(qpos, qvel, U)
            if stream is not None:
                ev1.record(stream)
                ev1.synchronize()
                opt_ms = ev0.elapsed_time(ev1)
            host_ms = (time.perf_counter() - t0) * 1e3
            if stream is None:
                opt_ms = host_ms
            U = traj.ctrl.cpu().numpy()
            self.replan_times_ms.append(opt_ms)
            self.replan_host_ms.append(host_ms)
            self.plan_cost_reduction.append(st.cost_reduction)
            if self.resync_mode == "opt_time":
                idx = min(int(opt_ms / (self.dt * 1e3)), H - 1)
            elif self.resync_mode == "best_match":
                with self._state_lock:
                    cur_q, cur_v = self._qpos.copy(), self._qvel.copy()
                idx = best_match_index(traj.qpos.cpu().numpy(),
                                       traj.qvel.cpu().numpy(), cur_q, cur_v,
                                       H)
            else:
                idx = 1  # the reference hard-codes 1 (`main.cpp:707`)
            if start_idx is not None:
                self.consumed_per_plan.append(
                    min(self.buffer.consumed(), H) - start_idx)
            self.buffer.install(U, idx)
            start_idx = idx

    # ----- actor -----------------------------------------------------------

    def gravity_hold(self, qp, qv, plain: bool = False) -> torch.Tensor:
        """Hold-position controls (nu, B) at (qp (nq, B), qv (nv, B)) on the
        task's device: qfrc_bias from `ops.fk_bias`, over each gear."""
        _, _, _, bias = ops.fk_bias(self.task, qp, qv, plain=plain)
        return gravity_compensation_ctrl(
            self.task, Data(qpos=qp, qvel=qv, ctrl=None, qfrc_bias=bias))

    def step(self, qp, qv, u, plain: bool = False):
        """One step of the actor from (qp (nq, B), qv (nv, B)) under u (nu,
        B): K3 at H = 1 -> (qpos, qvel) after it."""
        tg = self._targets.expand(-1, qp.shape[-1]).contiguous()
        qps, qvs, _ = ops.rollout(self.task, qp, qv, u[None].contiguous(), tg,
                                  plain=plain)
        return qps[1], qvs[1]

    def _actor_step(self) -> bool:
        """Apply one control; True when the task is complete after it."""
        u = self.buffer.next_control()
        with self._state_lock:
            qpos, qvel = self._qpos, self._qvel
        task, nq = self.task, self.model.nq
        with self._on(self._act_stream if self._cuda else None):
            x = torch.as_tensor(np.concatenate([qpos, qvel]), **self._f64)
            qp, qv = x[:nq, None], x[nq:, None]
            if u is None:
                self.holds += 1
                u = self.gravity_hold(qp, qv)[:, 0].cpu().numpy()
            u = u + self._rng.normal(0.0, self._noise_std)
            u = np.clip(u, self._limits[:, 0], self._limits[:, 1])
            qn, vn = self.step(qp, qv, torch.as_tensor(u, **self._f64)[:, None])
            parts = [qn[:, 0], vn[:, 0]]
            if task.task_complete_fn is not None:
                parts.append(task.task_complete_fn(qn, self._targets)[0]
                             .to(self.model.dtype))
            out = torch.cat(parts).cpu().numpy()     # syncs this stream
            done = len(out) > nq + self.model.nv and bool(out[-1])
            out = out[:nq + self.model.nv]
        with self._state_lock:
            self._qpos = out[:nq]
            self._qvel = out[nq:]
        self.applied_controls.append(u)
        self.visited_qpos.append(out[:nq])
        self.visited_qvel.append(out[nq:])
        return done

    def episode_cost(self) -> float:
        """The task cost of the visited states (post-step) with the applied
        controls, terminal weights at the last (the reference's end-of-run
        replay, `main.cpp:585-625`)."""
        if not self.visited_qpos:
            return float("nan")
        task = self.task
        qp = torch.as_tensor(np.array(self.visited_qpos).T, **self._f64)
        qv = torch.as_tensor(np.array(self.visited_qvel).T, **self._f64)
        us = torch.as_tensor(np.array(self.applied_controls).T, **self._f64)
        r = task.residual_fn(qp, qv, us, self._targets)     # (nres, N)
        w = task.weights[:, None].expand(-1, r.shape[1]).clone()
        w[:, -1] = task.weights_terminal
        return float((w * r * r).sum())

    def stats(self) -> dict:
        """The episode's replan and actor measurements."""
        ts = np.asarray(self.replan_times_ms)
        cpp = np.asarray(self.consumed_per_plan)
        out = {
            "replans": len(ts),
            "median_replan_ms": float(np.median(ts)) if len(ts) else None,
            "p95_replan_ms": (float(np.percentile(ts, 95)) if len(ts)
                              else None),
            "mean_replan_ms": float(ts.mean()) if len(ts) else None,
            "replan_rate_hz": 1e3 / float(ts.mean()) if len(ts) else None,
            "mean_replan_host_ms": (float(np.mean(self.replan_host_ms))
                                    if self.replan_host_ms else None),
            "controls_per_plan": float(cpp.mean()) if len(cpp) else None,
            "improved_plans": int(np.sum(np.asarray(self.plan_cost_reduction)
                                         > 0)),
            "holds": self.holds,
            "overruns": self.overruns,
            "max_lateness_ms": self.max_lateness_s * 1e3,
            "steps": len(self.applied_controls),
            "timing": ("cuda events + synchronize" if self._cuda
                       else "host clock"),
        }
        if self._native:
            out["buffer"] = self.buffer.native.stats
        return out

    def run(self, U_init, max_steps: int = 2000):
        """Run the episode -> (visited qpos (n, nq), applied controls (n,
        nu)); raises what the planner raised."""
        planner = threading.Thread(target=self._planner_loop,
                                   args=(U_init,), daemon=True)
        planner.start()
        ticker = None
        switch = sys.getswitchinterval()
        if self.realtime:
            sys.setswitchinterval(REALTIME_SWITCH_INTERVAL_S)
        try:
            while not self.buffer.has_plan() and self.error is None:
                time.sleep(1e-3)
            if self.realtime:
                from .native_executor import RtTicker
                ticker = RtTicker(self.dt)
            for _ in range(max_steps):
                if self.error is not None:
                    break
                if self._actor_step():
                    break
                if ticker is None:
                    continue
                late = ticker.wait()           # absolute-deadline pacing
                if late > 0:
                    self.overruns += 1
                    self.max_lateness_s = max(self.max_lateness_s, late)
        finally:
            self._stop.set()
            planner.join()
            sys.setswitchinterval(switch)
        if self.error is not None:
            raise RuntimeError("the async MPC planner failed") \
                from self.error
        return np.array(self.visited_qpos), np.array(self.applied_controls)
