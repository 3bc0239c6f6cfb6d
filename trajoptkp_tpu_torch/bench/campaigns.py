"""Campaigns (counterpart of `trajoptkp_tpu/bench/campaigns.py`): the
synchronous MPC horizon sweep.

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
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels import ops
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
