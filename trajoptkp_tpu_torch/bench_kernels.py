"""Time the kernels alone at a task's main-path shape on the card.

    python -m trajoptkp_tpu_torch.bench_kernels --task acrobot --H 500 --B 512
    python -m trajoptkp_tpu_torch.bench_kernels --task reaching --H 1500 --B 128
    python -m trajoptkp_tpu_torch.bench_kernels --task walker_run --H 40 --B 128
    python -m trajoptkp_tpu_torch.bench_kernels --task box_sweep --H 1500 --B 128
    python -m trajoptkp_tpu_torch.bench_kernels --task pushing_low_clutter \
        --H 1000 --B 128 --reps 1 --rounds 1
    python -m trajoptkp_tpu_torch.bench_kernels --task pushing_no_clutter \
        --H 1000 --B 128 --kernels rollout,linesearch,ad_jacobian,backward \
        --rolled

The rollout, line search, FD slot Jacobians and backward pass, the exact slot
Jacobians (K5ad), the cost expansion (K6) and the MPC replan's apply step (K8,
one applied control) where the tree has them. Each kernel is launched `--reps`
times between two CUDA events, after two warm-up launches, `--rounds` times
over; the inputs are the zero-control nominal of `lanes.scenes(seed=0)` with
SI_1 slots, or for a task with initial controls (pushing_no_clutter,
pushing_low_clutter, pushing_moderate_clutter_constrained, box_sweep,
threeD_push) the nominal of its scene generator's scenes (seed 0) under its
servo's controls, as chip_smoke.py's main paths start (push_lcl's kernels
take seconds a launch there: keep --reps and --rounds at 1; its K8 library
builds at its first launch).  Prints one JSON line
with the card's name and power limit, the per-launch milliseconds of every
round, and the sweeps per lane that the backward pass makes on these inputs
(`bp_sweeps_per_lane`), with the exact Jacobians it is timed on and with
central-FD ones (with the exact ones alone when `--kernels` leaves out
fd_jacobian).  `--rolled` builds and loads every library with its loops
rolled (TRAJOPT_ROLL_LOOPS), as the instances past build.ROLL_NV dofs and
the backward passes past build.ROLL_NX are built: a run with it and one
without time the two builds of one instance against each other.  To
compare two trees on one card, run this file once per tree inside one job,
with PYTHONPATH set to the tree under test, in the order parent, change,
change, parent. """

import argparse
import json
import subprocess

import torch

from trajoptkp_tpu_torch.config.loader import make_task
from trajoptkp_tpu_torch.kernels import build, ops
from trajoptkp_tpu_torch.solver import ilqr, lanes


def event_ms(fn, reps):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bp_sweeps_per_lane(task, plan, qpos, qvel, U, l, lam, cfg,
                       routes=("ad", "fd")):
    """Sweeps each lane of the backward pass (K7) makes under its coupled λ
    loop, on the inputs built from each Jacobian route ("ad", "fd").  Every
    lane makes the same number; 1 means no lane retried, and then a
    per-lane λ retry makes 1 sweep per lane too."""
    out = {}
    for route in routes:
        A, Bm = lanes.jacobians_si(task, plan, qpos, qvel, U,
                                   lanes.slot_jacobians(task, route))
        info = {}
        ops.backward(A, Bm, *l, lam, cfg, info=info)
        out[route] = 1 + int(info["rounds"])
    return out


def bench_inputs(task, H, B):
    """(qpos0 (nq, B), qvel0, targets, U (H, nu, B)) a main path starts
    from: the zero-control scenes, or the task's scenes and servo."""
    f64 = dict(dtype=torch.float64, device="cuda")
    if task.init_controls_fn is None:
        qp, qv, tg = lanes.scenes(task, B, seed=0)
        return (qp.T.contiguous(), qv.T.contiguous(), tg.T.contiguous(),
                torch.zeros((H, task.model.nu, B), **f64))
    if task.residual_kind[0] == "push":
        from trajoptkp_tpu_torch.tasks.pushing import push_scenes as scenes
    else:
        from trajoptkp_tpu_torch.tasks.manipulation import (
            box_scenes as scenes)
    qp, qv, tg = (x.T.contiguous() for x in scenes(task, B, seed=0))
    qp, qv, U = task.init_controls_fn(task, H, qp, qv, tg)
    return qp.contiguous(), qv.contiguous(), tg, U.contiguous()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--task", default="acrobot")
    ap.add_argument("--H", type=int, default=500)
    ap.add_argument("--B", type=int, default=512)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", help="time only these kernels "
                    "(comma-separated); all by default")
    ap.add_argument("--rolled", action="store_true",
                    help="every library with its loops rolled")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: no CUDA device is available")
    if args.rolled:
        build.ROLL_NV = build.ROLL_NX = 0
    task = make_task(args.task, device="cuda")
    task = task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name="set_interval", min_N=1))
    cfg = ilqr.ILQRConfig()
    H, B = args.H, args.B
    qp0, qv0, tgl, U = bench_inputs(task, H, B)
    plan = lanes.si_plan(task, H)
    alphas = ilqr.default_alphas(cfg.num_parallel_rollouts, device="cuda")
    qpos, qvel, _ = ops.rollout(task, qp0, qv0, U, tgl)
    A, Bm = lanes.jacobians_si(task, plan, qpos, qvel, U,
                               lanes.slot_jacobians(task, "ad"))
    l = lanes.cost_expansion(task, qpos, qvel, U, tgl)
    lam = torch.full((B,), cfg.lambda_init, dtype=torch.float64,
                     device="cuda")
    k, K = ops.backward(A, Bm, *l, lam, cfg)[:2]
    only = args.kernels.split(",") if args.kernels else None
    sweeps = bp_sweeps_per_lane(
        task, plan, qpos, qvel, U, l, lam, cfg,
        ("ad", "fd") if only is None or "fd_jacobian" in only else ("ad",))
    calls = {
        "rollout": lambda: ops.rollout(task, qp0, qv0, U, tgl),
        "linesearch": lambda: ops.linesearch(task, qpos, qvel, U, k, K,
                                             alphas, tgl),
        "fd_jacobian": lambda: ops.fd_jacobian(task, qpos, qvel, U,
                                               plan.times, cfg.fd_eps),
        "backward": lambda: ops.backward(A, Bm, *l, lam, cfg),
    }
    if hasattr(ops, "ad_jacobian"):
        calls["ad_jacobian"] = lambda: ops.ad_jacobian(task, qpos, qvel, U,
                                                       plan.times)
    if hasattr(ops, "cost_expansion"):
        calls["cost_expansion"] = lambda: ops.cost_expansion(
            task, qpos, qvel, U, tgl)
    if hasattr(ops, "mpc_apply"):
        from trajoptkp_tpu_torch.mpc.sync import noise_std

        costs = ops.rollout(task, qp0, qv0, U, tgl)[2].sum(0)
        accept = torch.arange(B, device="cuda") % 2 == 0
        z = torch.zeros((1, task.model.nu, B), dtype=torch.float64,
                        device="cuda")
        std = noise_std(task, 5.0)
        calls["mpc_apply"] = lambda: ops.mpc_apply(
            task, qp0, qv0, U, U, accept, costs, costs, z, std, tgl)
    ms = {name: [event_ms(fn, args.reps) for _ in range(args.rounds)]
          for name, fn in calls.items() if only is None or name in only}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "task": args.task, "H": H, "B": B,
                      "reps": args.reps, "rolled": args.rolled,
                      "card": card, "ms": ms,
                      "bp_sweeps_per_lane": sweeps}), flush=True)


if __name__ == "__main__":
    main()
