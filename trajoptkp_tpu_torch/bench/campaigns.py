"""Campaigns (counterpart of `trajoptkp_tpu/bench/campaigns.py`): the
synchronous MPC horizon sweep and the asynchronous MPC trials.

`sync_mpc_horizon_sweep` is GenDataMPCHorizons (`GenTestingData.cpp:
275-326`): per horizon, one MPC episode batch advanced by the lane executor
(replan, apply `num_apply` noisy controls, shift, repeat), each replan timed
on its own.  On the card a replan's time is CUDA events around it and a
synchronize after it (`mpc/sync.py:make_lane_sync_mpc_host`), so it is the
device's work and not the host's dispatch (the JAX H = 20 row timed
dispatch only, `TestingData/walker_run_sync_mpc_20260821_0651/README.md`).
The first replan is left out of the statistics (it loads the kernels).  The
rows keep the JAX schema and `mpc_horizons.csv` its columns, written after
every horizon.

`async_mpc_campaign` is TestingMPC / SingleMPCRun in the asynchronous mode
(`GenTestingData.cpp`'s GenDataAsyncMPC): per scene one episode of
`mpc/async_mpc.py:AsyncMPC` from zero controls, its steps, wall time,
replans, final task distance, episode cost and completion, in the JAX
rows and `async_mpc.csv` columns, with the replans' device times (CUDA
events), the controls taken per plan, the gravity holds and the ticker's
overruns beside them.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels import ops
from ..mpc.async_mpc import AsyncMPC
from ..mpc.sync import make_lane_sync_mpc_host
from ..solver.ilqr import ILQRConfig
from ..tasks.base import Task

CSV_COLUMNS = ("horizon,opt_time_ms,median_opt_time_ms,p95_opt_time_ms,"
               "replan_rate_hz,mean_running_cost")


def episode_starts(task: Task, B: int, seed: int = 0, spread: float = 0.05):
    """(qposB, qvelB, targetsB) of B episodes: the task's start for B = 1,
    else qpos_start + spread N(0, 1) from a numpy seed; zero velocities."""
    f64 = dict(dtype=task.model.dtype, device=task.model.device)
    qp = task.qpos_start.cpu().numpy()[None, :].repeat(B, 0)
    if B > 1:
        qp = qp + spread * np.random.default_rng(seed).standard_normal(
            qp.shape)
    return (torch.as_tensor(qp, **f64),
            torch.zeros((B, task.model.nv), **f64),
            task.residual_targets[None, :].expand(B, -1).contiguous())


def sync_mpc_horizon_sweep(task: Task, cfg: ILQRConfig,
                           horizons: Sequence[int], n_replans: int = 100,
                           num_apply: int = 1, out_dir: Optional[str] = None,
                           seed: int = 0, B: int = 1):
    """Replan time against horizon: one row per horizon with the JAX keys
    (horizon, opt_time_ms (mean), median_opt_time_ms, p95_opt_time_ms,
    replan_rate_hz, mean_running_cost of the visited states) over replans 2
    to n_replans, and B, the episode replans per second, the kernel
    launches per replan and how the replans were timed."""
    model = task.model
    rows = []
    for H in horizons:
        qp, qv, tg = episode_starts(task, B, seed)
        U0 = torch.zeros((B, H, model.nu), dtype=model.dtype,
                         device=model.device)
        gen = torch.Generator(device=model.device)
        gen.manual_seed(seed)
        mpc = make_lane_sync_mpc_host(task, cfg, H, num_apply)
        before = dict(ops.LAUNCHES)
        res = mpc(qp, qv, U0, tg, n_replans, gen)
        launches = {k: (v - before[k]) / n_replans
                    for k, v in ops.LAUNCHES.items() if v > before[k]}
        ts = np.asarray(mpc.last_replan_ms[1:] or mpc.last_replan_ms)
        ms = float(ts.mean())
        rows.append({
            "horizon": H,
            "opt_time_ms": ms,
            "replan_rate_hz": 1e3 / ms,
            "mean_running_cost": float(res.cost_hist.mean()),
            "median_opt_time_ms": float(np.median(ts)),
            "p95_opt_time_ms": float(np.percentile(ts, 95)),
            "B": B,
            "n_replans": n_replans,
            "episode_replans_per_s": B * 1e3 / ms,
            "launches_per_replan": launches,
            "timing": ("cuda events + synchronize"
                       if model.device.type == "cuda" else "host clock"),
        })
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "mpc_horizons.csv"), "w") as f:
                f.write(CSV_COLUMNS + "\n")
                for r in rows:
                    f.write(f"{r['horizon']},{r['opt_time_ms']:.4g},"
                            f"{r['median_opt_time_ms']:.4g},"
                            f"{r['p95_opt_time_ms']:.4g},"
                            f"{r['replan_rate_hz']:.4g},"
                            f"{r['mean_running_cost']:.6g}\n")
    return rows


ASYNC_CSV_COLUMNS = ("trial,steps,wall_s,replans,mean_replan_ms,final_dist,"
                     "episode_cost,task_complete")


def async_scenes(task: Task, N: int, seed: int = 0) -> np.ndarray:
    """(N, nq) start poses of the async campaign (JAX `app.py:
    _async_mpc_campaign:445-449`): qpos_start plus 0.2 N(0, 1) on the
    first min(nu, nq) coordinates, from `np.random.default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(task.qpos_start.cpu().numpy(), (N, 1))
    n_rj = min(task.model.nu, task.model.nq)
    qpos[:, :n_rj] += 0.2 * rng.standard_normal((N, n_rj))
    return qpos


def _object_disp(model, qpos0, qpos_hist) -> Optional[float]:
    """The horizontal distance the pushed object (the free body "goal")
    moved from its start to the episode's last state; None without one."""
    if "goal" not in model.joint_names or not len(qpos_hist):
        return None
    qa = model.jnt_qposadr[model.joint_names.index("goal")]
    d = np.asarray(qpos_hist[-1])[qa:qa + 2] - np.asarray(qpos0)[qa:qa + 2]
    return float(np.hypot(d[0], d[1]))


def async_mpc_campaign(task: Task, cfg: ILQRConfig, scenes_qpos,
                       horizon: int, max_steps: int = 1000,
                       out_dir: Optional[str] = None, realtime: bool = False):
    """Async-MPC trials over scenes (JAX `async_mpc_campaign`): one
    AsyncMPC episode per start pose (noise seed = the trial's index) from
    zero controls, max_steps actor steps or until the task completes.  One
    row per trial with the JAX keys (trial, steps, wall_s, replans,
    mean_replan_ms, final_dist, episode_cost, task_complete), the pushed
    object's displacement (`object_disp`), the task's residuals at the last
    state and the episode's `AsyncMPC.stats()`;
    `async_mpc.csv` under out_dir."""
    model = task.model
    f64 = dict(dtype=model.dtype, device=model.device)
    rows = []
    for i, qpos0 in enumerate(scenes_qpos):
        t = task.replace(qpos_start=torch.as_tensor(qpos0, **f64))
        runner = AsyncMPC(t, cfg, horizon, realtime=realtime, seed=i)
        U0 = np.zeros((horizon, model.nu))
        t0 = time.perf_counter()
        qpos_hist, u_hist = runner.run(U0, max_steps=max_steps)
        wall = time.perf_counter() - t0
        dist = float("nan")
        if task.task_complete_fn is not None and len(qpos_hist):
            _, dd = task.task_complete_fn(
                torch.as_tensor(qpos_hist[-1], **f64)[:, None],
                t.residual_targets[:, None])
            dist = float(dd[0])
        st = runner.stats()
        res = []
        if len(qpos_hist):
            res = task.residual_fn(
                torch.as_tensor(qpos_hist[-1], **f64)[:, None],
                torch.as_tensor(runner.visited_qvel[-1], **f64)[:, None],
                torch.as_tensor(u_hist[-1], **f64)[:, None],
                t.residual_targets[:, None])[:, 0].tolist()
        rows.append({
            "trial": i,
            "steps": len(u_hist),
            "object_disp": _object_disp(model, qpos0, qpos_hist),
            "wall_s": wall,
            "replans": st["replans"],
            "mean_replan_ms": (st["mean_replan_ms"] if st["replans"]
                               else float("nan")),
            "final_dist": dist,
            "episode_cost": runner.episode_cost(),
            # broke out on TaskComplete
            "task_complete": int(len(u_hist) < max_steps),
            "final_residuals": res,
            **{k: v for k, v in st.items() if k not in ("replans", "steps",
                                                        "mean_replan_ms")},
        })
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "async_mpc.csv"), "w") as f:
            f.write(ASYNC_CSV_COLUMNS + "\n")
            for r in rows:
                f.write(f"{r['trial']},{r['steps']},{r['wall_s']:.4g},"
                        f"{r['replans']},{r['mean_replan_ms']:.4g},"
                        f"{r['final_dist']:.4g},{r['episode_cost']:.6g},"
                        f"{r['task_complete']}\n")
    return rows
