"""Command-line entry point (counterpart of `trajoptkp_tpu/app.py`):
Optimise_once, MPC_until_completion, Generate_syncronus_mpc_data and
Generate_asynchronus_mpc_data.

    python -m trajoptkp_tpu_torch.app --task acrobot --runMode Optimise_once \\
        [--keypoint VC_1_200 --horizon H --maxIter N --minIter N --device cuda]
    python -m trajoptkp_tpu_torch.app --task reaching --runMode Optimise_once
    python -m trajoptkp_tpu_torch.app --task pushing_no_clutter \\
        --runMode Optimise_once --keypoint AJ_5_100
    python -m trajoptkp_tpu_torch.app --task box_sweep --runMode Optimise_once
    python -m trajoptkp_tpu_torch.app --task threeD_push \\
        --runMode Optimise_once
    python -m trajoptkp_tpu_torch.app --task walker_run \\
        --runMode Generate_syncronus_mpc_data [--horizon 40]
    python -m trajoptkp_tpu_torch.app --task acrobot \\
        --runMode MPC_until_completion
    python -m trajoptkp_tpu_torch.app --task pushing_no_clutter \\
        --runMode Generate_asynchronus_mpc_data --num_scenes 3 --keypoint SI_1

Tasks: acrobot, pentabot, reaching (panda arm with joint limits),
pushing_no_clutter (panda pushes a free cylinder on a table: contacts),
walker_walk and walker_run (planar walker: three joints on its torso, capsule
contacts), box_sweep and threeD_push (the panda sweeps a heavy box or pushes a
small one that can topple: plane-box and cylinder-box contacts, the box's six
dofs in the state).  For Optimise_once the horizon defaults to the task's (500,
500, 1500, 1000, 500, 1500, 1000).  The controls start at zero, or for pushing
from the task's servo: a 1000-step setup servo behind the object, whose end
state is the solve's start, then the init servo over the horizon (the JAX app's
`_batch_init_controls`); the box tasks take the init servo from their start
alone (they have no setup servo, JAX `app.py:_prepare_start`).  Prints
per-iteration banner lines and a final JSON line with the initial and final
cost, the cost reduction and the mean %derivs.

Keypoint methods (`--keypoint`; each task's own when omitted: acrobot and
reaching velocity_change, pushing and box_sweep adaptive_jerk, pentabot, the
walkers and threeD_push set_interval): SI_n (set_interval every n steps),
AJ_a_b (adaptive_jerk), AA_a_b (adaptive_accel), VC_a_b (velocity_change) and
IE_a_b (iterative_error), with min_N = a and max_N = b and the task's
thresholds.

Generate_syncronus_mpc_data is the JAX app's `_sync_mpc_campaign`
(GenDataMPCHorizons): synchronous MPC of one episode from the task's start,
one iLQR iteration per replan, one control applied with 5% noise, 200
replans at each horizon 20, 30, ..., 80, or at `--horizon` alone; it writes
`mpc_horizons.csv` under `--out_dir` (trajoptkp_tpu_torch_out/) and prints a
final JSON line with one row per horizon (median and p95 ms per replan).

MPC_until_completion is asynchronous MPC (mpc/async_mpc.py: a planner
thread replanning one iLQR iteration at a time while the actor applies the
plan with 5% noise) from the task's start over its MPC horizon, 2000 actor
steps or until the task completes, not paced to the wall clock, as the JAX
app runs it; the controls start at zero, or for pushing from the task's
init servo from its start.  Its JSON line has the steps, the replans and
their mean, median and p95 device ms, the controls taken per plan, the
gravity holds, the episode cost and whether the task completed.
Generate_asynchronus_mpc_data runs it over min(--num_scenes, 25) scenes
(the task's start with 0.2 N(0, 1) on its first min(nu, nq) coordinates,
seeded by --seed), 500 steps each from zero controls, writes
`async_mpc.csv` under `--out_dir` and prints the campaign directory and
the number of trials.

`--deriv_mode` picks the generic solve's dynamics Jacobians (Optimise_once
and the asynchronous MPC's planner): auto and fd are central differences
(K5), ad and ad_time the exact forward-mode Jacobians (K5ad, the
constraint solve differentiated implicitly); the synchronous lane MPC
replan takes the exact ones always, as the JAX lane program does.

Runs on the card by default; `--device cpu` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .kernels import ops
from .solver.ilqr import DERIV_MODES

RUN_MODES = ("Optimise_once", "MPC_until_completion",
             "Generate_syncronus_mpc_data", "Generate_asynchronus_mpc_data")
RUN_MODES_LATER = {
    "Init_controls": "ROADMAP: the harness, config, CLI and bench work",
    "Generate_test_scenes": "ROADMAP: the harness, config, CLI and bench work",
    "Generate_openloop_data": "ROADMAP: the harness, config, CLI and bench work",
}
SYNC_MPC_HORIZONS = (20, 30, 40, 50, 60, 70, 80)
SYNC_MPC_REPLANS = 200          # replans per horizon, as the JAX campaign
ASYNC_MPC_STEPS = 2000          # MPC_until_completion's actor steps
ASYNC_CAMPAIGN_STEPS = 500      # per trial of the async campaign
ASYNC_CAMPAIGN_MAX_SCENES = 25  # async trials are wall-clock serial


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--task", default="acrobot",
                   help="acrobot, pentabot, reaching, pushing_no_clutter, "
                   "walker_walk, walker_run, box_sweep or threeD_push")
    p.add_argument("--runMode", default="Optimise_once")
    p.add_argument("--keypoint", help="keypoint method: SI_n, AJ_a_b, "
                   "AA_a_b, VC_a_b or IE_a_b (min_N a, max_N b); the task's "
                   "own method when omitted")
    p.add_argument("--horizon", type=int, default=None)
    p.add_argument("--maxIter", type=int, default=10)
    p.add_argument("--minIter", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu for the plain path")
    p.add_argument("--num_scenes", type=int, default=100,
                   help="Generate_asynchronus_mpc_data: scenes (at most 25)")
    p.add_argument("--scenes_dir", help="TestTasks-format scene CSV "
                   "directory (not ported)")
    p.add_argument("--out_dir", default="trajoptkp_tpu_torch_out",
                   help="where the MPC campaigns write their directories")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the MPC exploration noise and the async "
                   "campaign's scenes")
    p.add_argument("--deriv_mode", default="auto",
                   choices=("auto",) + DERIV_MODES,
                   help="the generic solve's dynamics Jacobians: fd central "
                   "differences (K5), ad or ad_time exact forward mode "
                   "(K5ad); auto is fd, as the JAX app's rule gives in "
                   "float64 off a TPU.  The lane MPC replan takes ad always")
    return p


def resolve_deriv_mode(mode: str, kp_cfg, keypoint_given: bool) -> str:
    """The JAX app's rule (`app.py:97-122`) in float64 off a TPU: auto is
    fd; ad with a set_interval `--keypoint` becomes ad_time."""
    if mode == "auto":
        return "fd"
    if (mode == "ad" and keypoint_given and kp_cfg is not None
            and kp_cfg.name == "set_interval"):
        return "ad_time"
    return mode


KEYPOINT_KINDS = {"SI": "set_interval", "AJ": "adaptive_jerk",
                  "AA": "adaptive_accel", "VC": "velocity_change",
                  "IE": "iterative_error"}


def parse_keypoint_name(kp_cfg, name: str):
    """SI_n / AJ_a_b / AA_a_b / VC_a_b / IE_a_b -> the task's keypoint
    config with that method, min_N and max_N (JAX `app.py:251-265`; the
    thresholds stay the task's)."""
    parts = name.split("_")
    kind = KEYPOINT_KINDS.get(parts[0])
    sizes = parts[1:]
    if (kind is None or not all(p.isdigit() for p in sizes)
            or len(sizes) != (1 if parts[0] == "SI" else 2)):
        raise ValueError(
            f"keypoint method {name!r}: want SI_n, AJ_a_b, AA_a_b, VC_a_b "
            "or IE_a_b")
    if parts[0] == "SI":
        return kp_cfg.replace(name=kind, min_N=int(sizes[0]))
    return kp_cfg.replace(name=kind, min_N=int(sizes[0]),
                          max_N=int(sizes[1]))


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .config.loader import make_task
    from .solver.ilqr import ILQRConfig, optimise

    if args.runMode not in RUN_MODES:
        later = RUN_MODES_LATER.get(args.runMode, "a later ROADMAP item")
        raise NotImplementedError(
            f"run mode {args.runMode!r} is not ported yet ({later}); the "
            f"port has {', '.join(RUN_MODES)}")
    task = make_task(args.task, device=args.device)
    if args.keypoint:
        task = task.replace(
            keypoint_cfg=parse_keypoint_name(task.keypoint_cfg, args.keypoint))
    cfg = ILQRConfig(max_iterations=args.maxIter,
                     min_iterations=args.minIter,
                     deriv_mode=resolve_deriv_mode(
                         args.deriv_mode, task.keypoint_cfg,
                         bool(args.keypoint)))
    if args.runMode == "Generate_syncronus_mpc_data":
        return sync_mpc_campaign(task, cfg, args)
    if args.runMode == "MPC_until_completion":
        return mpc_until_completion(task, cfg, args)
    if args.runMode == "Generate_asynchronus_mpc_data":
        return async_mpc_campaign(task, cfg, args)
    H = args.horizon or task.openloop_horizon
    qpos0, qvel0 = task.qpos_start, task.qvel_start
    U = torch.zeros((H, task.model.nu), dtype=task.model.dtype,
                    device=task.model.device)
    init_s = 0.0
    if task.init_controls_fn is not None:
        t0 = time.perf_counter()
        qp, qv, UB = task.init_controls_fn(
            task, H, qpos0[:, None], qvel0[:, None],
            task.residual_targets[:, None])
        qpos0, qvel0, U = qp[:, 0], qv[:, 0], UB[..., 0]
        init_s = time.perf_counter() - t0
        servo = ("setup and init servo" if task.residual_kind[0] == "push"
                 else "init servo")
        print(f"init controls ({servo}): {init_s:.1f} s", flush=True)
    traj, stats = optimise(task, qpos0, qvel0, U, cfg, verbose=True)
    print(json.dumps({
        "task": task.name, "horizon": H,
        "initial_cost": stats.initial_cost,
        "final_cost": stats.final_cost,
        "cost_reduction": stats.cost_reduction,
        "iterations": stats.num_iterations,
        "keypoint_method": task.keypoint_cfg.name,
        "deriv_mode": cfg.deriv_mode,
        "mean_pct_derivs": (sum(stats.percent_derivs)
                            / max(len(stats.percent_derivs), 1)),
        "opt_time_ms": stats.opt_time_ms,
        "init_controls_s": init_s,
        # the kernels the run launched (none on the CPU)
        "launches": {k: v for k, v in ops.LAUNCHES.items() if v},
    }), flush=True)


def sync_mpc_campaign(task, cfg, args):
    """GenDataMPCHorizons (JAX `app.py:_sync_mpc_campaign`): the replan
    time against horizon, or at `--horizon` alone."""
    from .bench.campaigns import sync_mpc_horizon_sweep

    horizons = [args.horizon] if args.horizon else list(SYNC_MPC_HORIZONS)
    out_dir = os.path.join(
        args.out_dir, f"{task.name}_sync_mpc_{time.strftime('%Y%m%d_%H%M')}")
    rows = sync_mpc_horizon_sweep(task, cfg, horizons,
                                  n_replans=SYNC_MPC_REPLANS, out_dir=out_dir,
                                  seed=args.seed)
    print(json.dumps({"campaign": out_dir, "rows": rows}), flush=True)


def mpc_init_controls(task, H: int):
    """The JAX app's `_init_controls` (H, nu): the pushing and box tasks'
    init servo from the task's start (no setup servo), zeros elsewhere."""
    if task.init_controls_fn is not None:
        from .tasks.pushing import jacobian_ee_init_controls
        return jacobian_ee_init_controls(
            task, H, task.qpos_start[:, None], task.qvel_start[:, None],
            task.residual_targets[:, None])[..., 0].cpu().numpy()
    return np.zeros((H, task.model.nu))


def mpc_until_completion(task, cfg, args):
    """Asynchronous MPC until the task completes (JAX `app.py:168-179`)."""
    from .mpc.async_mpc import AsyncMPC

    H = task.mpc_horizon
    runner = AsyncMPC(task, cfg, H, seed=args.seed)
    _, u_hist = runner.run(mpc_init_controls(task, H),
                           max_steps=ASYNC_MPC_STEPS)
    st = runner.stats()
    print(json.dumps({
        "task": task.name, "steps": len(u_hist),
        "replans": st["replans"], "mean_replan_ms": st["mean_replan_ms"],
        "median_replan_ms": st["median_replan_ms"],
        "p95_replan_ms": st["p95_replan_ms"],
        "controls_per_plan": st["controls_per_plan"], "holds": st["holds"],
        "episode_cost": runner.episode_cost(),
        "task_complete": len(u_hist) < ASYNC_MPC_STEPS,
        "keypoint_method": task.keypoint_cfg.name, "horizon": H,
        "timing": st["timing"],
    }), flush=True)


def async_mpc_campaign(task, cfg, args):
    """GenDataAsyncMPC (JAX `app.py:_async_mpc_campaign:433-456`)."""
    from .bench import campaigns

    if args.scenes_dir:
        raise NotImplementedError(
            "--scenes_dir reads the reference's TestTasks CSVs: the "
            "YAML/CSV layer (ROADMAP: the harness, config, CLI and bench work)")
    N = min(args.num_scenes, ASYNC_CAMPAIGN_MAX_SCENES)
    out_dir = os.path.join(
        args.out_dir, f"{task.name}_async_mpc_{time.strftime('%Y%m%d_%H%M')}")
    rows = campaigns.async_mpc_campaign(
        task, cfg, campaigns.async_scenes(task, N, args.seed),
        task.mpc_horizon, max_steps=ASYNC_CAMPAIGN_STEPS, out_dir=out_dir)
    print(json.dumps({"campaign": out_dir, "trials": len(rows),
                      "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
