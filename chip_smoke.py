#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the four CUDA kernels from kernels/csrc, holds each against its plain
PyTorch twin on the card (acrobot at the main path's shapes, pentabot at a
smaller size), replays the acrobot SI_5 H=200 golden solve on the kernel
path, drives the main path (acrobot SI_1, H=500, 512 scenes, 10 iterations,
float64) through `make_lane_phase_optimise` with launch counts, compares 3
iterations of it with the plain path on the card, and runs the CLI.

Prints the card's name and power limit, the kernel build time, a `record`
line with every measurement, one `{"kernels": [...]}` line and, last,
`{"ok": true, "device": {...}}`.  Any failed check is printed as it happens
and makes the script exit non-zero at the end without a result; it also
fails where no CUDA device is present.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from trajoptkp_tpu_torch.kernels import build, ops
from trajoptkp_tpu_torch.solver import ilqr, lanes
from trajoptkp_tpu_torch.solver.ilqr import ILQRConfig
from trajoptkp_tpu_torch.tasks.toys import make_acrobot, make_pentabot

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "acrobot_si5_h200.npz")

H, B, ITERS = 500, 512, 10          # the main path
PH, PB = 100, 64                    # pentabot check size
# H100 SXM data sheet: HBM3 3.35 TB/s; FP64 (non-tensor) 34 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 34e12
F8 = 8

# kernel-vs-plain bars: relative to the largest magnitude compared
# (rollout, line search over the first 100 steps: acrobot is chaotic and
# rounding differences grow along the horizon), absolute for FD columns
# (FD divides rounding by 2 eps = 2e-6)
TOL = {
    "rollout": ("rel", 1e-10),
    "linesearch": ("rel", 1e-10),
    "fd_jacobian": ("abs", 1e-7),
    "backward": ("rel", 1e-9),
}
PENTABOT_FD_ABS = 1e-6  # five-link FD noise (the JAX FD itself: 5.5e-8)
# golden bars of tests/test_torch_golden.py (FD-noise spread, see there)
CTRL_ATOL, QPOS_ATOL, COST_ATOL = 2e-4, 5e-5, 4e-4


FAILED = []  # failed checks; main() raises on them before any result


def check(cond, msg):
    """Record a failed check and go on, so one run reports every phase."""
    if not cond:
        print(f"FAILED: {msg}", flush=True)
        FAILED.append(msg)


def cuda_ms(fn, reps=1, warmup=1):
    """Mean device time of fn() in ms by CUDA events, after warm-up."""
    for _ in range(warmup):
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


def err(a, b, kind):
    d = float((a - b).abs().max())
    if kind == "rel":
        return d, d / max(float(b.abs().max()), 1e-300)
    return d, d


# ---- analytic operation and byte counts for the bounds ---------------------


def step_ops(nv, nu):
    """Double operations of one step of csrc/step.cuh, counted per part:
    FK ~230 per hinge body, body inertia ~190, RNE ~180, CRBA ~30 plus 11
    per ancestor pair, forces ~10 per dof and actuator, Cholesky nv^3/3 and
    its solve 2 nv^2, Euler 4 nv."""
    return (630 * nv + 11 * nv * (nv - 1) // 2 + 10 * (nv + nu)
            + nv ** 3 / 3 + 2 * nv ** 2 + 4 * nv)


def cost_ops(nv, nu):
    return 4 * (2 * nv + nu)


def bound(ops_count, bytes_count):
    t_ops = ops_count / F64_OPS_PER_S * 1e3
    t_bytes = bytes_count / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def rollout_bound(nv, nu, Hh, Bb):
    nres = 2 * nv + nu
    ops_ = Hh * Bb * (step_ops(nv, nu) + cost_ops(nv, nu))
    byt = F8 * Bb * (2 * nv + Hh * nu + nres + (Hh + 1) * 2 * nv + Hh)
    return bound(ops_, byt)


def linesearch_bound(nv, nu, Hh, A, Bb):
    nres, nx = 2 * nv + nu, 2 * nv
    ops_ = Hh * A * Bb * (step_ops(nv, nu) + cost_ops(nv, nu)
                          + 2 * nu * nx + 4 * nu + nx)
    byt = F8 * (Bb * ((Hh + 1) * nx + Hh * nu * (2 + nx) + nres) + A
                + A * Bb * ((Hh + 1) * nx + Hh * nu + Hh))
    return bound(ops_, byt)


def fd_bound(nv, nu, K, Bb):
    nx, nc = 2 * nv, 2 * nv + nu
    ops_ = K * Bb * (2 * nc * step_ops(nv, nu) + 2 * nc * nx)
    byt = F8 * K * (1 + Bb * (nx + nu + nx * nc))
    return bound(ops_, byt)


def backward_bound(nx, nu, Hh, Bb, sweeps):
    nc = nx + nu
    per_step = (2 * nx * nx * nc + 2 * nx * nc + 2 * nx * (nc * nc - nx * nu)
                + nu ** 3 / 3 + 2 * nu * nu * (nx + 1) + 2 * nu * nu * (nx + 1)
                + 6 * nx * nu + 6 * nx * nx * nu + 2 * nx * nx + 4 * nu)
    ops_ = sweeps * Hh * per_step
    byt = F8 * (Hh * Bb * (nx * nx + nx * nu + nx + nx * nx + nu + nu * nu)
                + Hh * Bb * (nu + nu * nx) + 3 * Bb) + Bb
    return bound(ops_, byt)


# ---- phases -----------------------------------------------------------------


def card_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def lane_inputs(task, Hh, Bb, seed):
    qp, qv, tg = lanes.scenes(task, Bb, seed=seed)
    rng = np.random.default_rng(seed + 1)
    nu, nx = task.model.nu, 2 * task.model.nv
    f64 = dict(dtype=torch.float64, device="cuda")
    U = torch.as_tensor(0.3 * rng.standard_normal((Hh, nu, Bb)), **f64)
    k = torch.as_tensor(0.1 * rng.standard_normal((Hh, nu, Bb)), **f64)
    K = torch.as_tensor(0.05 * rng.standard_normal((Hh, nu, nx, Bb)), **f64)
    return (qp.T.contiguous(), qv.T.contiguous(), tg.T.contiguous(), U, k, K)


def note(task, name, rows):
    print(f"  {task.name} {name}: kernel vs plain max abs err "
          f"{rows[name]['err'][0]:.3e} (compared {rows[name]['err'][1]:.3e})",
          flush=True)


def check_kernels(task, Hh, Bb, fd_abs, time_them):
    """Each kernel against its plain twin on the same inputs."""
    nv, nu = task.model.nv, task.model.nu
    qp0, qv0, tg, U, k, K = lane_inputs(task, Hh, Bb, seed=3)
    cfg = ILQRConfig()
    alphas = ilqr.default_alphas(cfg.num_parallel_rollouts, device="cuda")
    plan = lanes.si_plan(task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name="set_interval", min_N=1)), Hh)
    rows = {}

    # K3 rollout
    kr = ops.rollout(task, qp0, qv0, U, tg)
    pr = ops.rollout(task, qp0, qv0, U, tg, plain=True)
    n = min(100, Hh)
    e = max(err(kr[0][:n], pr[0][:n], "rel"), err(kr[1][:n], pr[1][:n], "rel"),
            err(kr[2][:n], pr[2][:n], "rel"), key=lambda x: x[1])
    rows["rollout"] = dict(err=e, bound=rollout_bound(nv, nu, Hh, Bb))
    note(task, "rollout", rows)
    if time_them:
        rows["rollout"]["ms"] = cuda_ms(lambda: ops.rollout(task, qp0, qv0, U, tg), 5)
        rows["rollout"]["plain_ms"] = cuda_ms(
            lambda: ops.rollout(task, qp0, qv0, U, tg, plain=True), 1, 0)

    # K4 line search, about the kernel rollout's nominal
    qpos, qvel = kr[0], kr[1]
    kl = ops.linesearch(task, qpos, qvel, U, k, K, alphas, tg)
    pl = ops.linesearch(task, qpos, qvel, U, k, K, alphas, tg, plain=True)
    e = max(err(kl[0][:n], pl[0][:n], "rel"), err(kl[2][:n], pl[2][:n], "rel"),
            err(kl[3][:n], pl[3][:n], "rel"), key=lambda x: x[1])
    rows["linesearch"] = dict(
        err=e, bound=linesearch_bound(nv, nu, Hh, len(alphas), Bb))
    note(task, "linesearch", rows)
    if time_them:
        rows["linesearch"]["ms"] = cuda_ms(
            lambda: ops.linesearch(task, qpos, qvel, U, k, K, alphas, tg), 5)
        rows["linesearch"]["plain_ms"] = cuda_ms(
            lambda: ops.linesearch(task, qpos, qvel, U, k, K, alphas, tg,
                                   plain=True), 1, 0)

    # K5 FD slot Jacobians at every step (SI_1) and K7 on the nominal the
    # main path starts from (zero controls on these scenes)
    U0 = torch.zeros_like(U)
    q0, v0, _ = ops.rollout(task, qp0, qv0, U0, tg)
    kj = ops.fd_jacobian(task, q0, v0, U0, plan.times, cfg.fd_eps)
    pj = ops.fd_jacobian(task, q0, v0, U0, plan.times, cfg.fd_eps,
                         plain=True)
    rows["fd_jacobian"] = dict(err=err(kj, pj, "abs"),
                               bound=fd_bound(nv, nu, len(plan.times), Bb))
    note(task, "fd_jacobian", rows)
    if time_them:
        rows["fd_jacobian"]["ms"] = cuda_ms(lambda: ops.fd_jacobian(
            task, q0, v0, U0, plan.times, cfg.fd_eps), 5)
        rows["fd_jacobian"]["plain_ms"] = cuda_ms(lambda: ops.fd_jacobian(
            task, q0, v0, U0, plan.times, cfg.fd_eps, plain=True), 1, 0)

    A, Bm = lanes.jacobians_si(task, plan, q0, v0, U0, cfg.fd_eps)
    l = lanes.cost_expansion(task, q0, v0, U0, tg)
    lam = torch.full((Bb,), cfg.lambda_init, dtype=torch.float64,
                     device="cuda")
    kb = ops.backward(A, Bm, *l, lam, cfg)
    pb = ops.backward(A, Bm, *l, lam, cfg, plain=True)
    # λ and λ-exit decide the next iteration: they must agree (λ to 1e-14)
    lam_off = (kb[3] - pb[3]).abs() > 1e-14 * pb[3]
    bad = ((kb[4] != pb[4]) | lam_off).nonzero().flatten()[:5]
    check(len(bad) == 0,
          f"backward: λ or λ-exit differ in lanes {bad.tolist()}: kernel λ "
          f"{kb[3][bad].tolist()} exit {kb[4][bad].tolist()}, plain λ "
          f"{pb[3][bad].tolist()} exit {pb[4][bad].tolist()}; kernel gains "
          f"finite {torch.isfinite(kb[0][..., bad]).all(0).all(0).tolist()}")
    e = max(err(kb[0], pb[0], "rel"), err(kb[1], pb[1], "rel"),
            err(kb[2], pb[2], "rel"), key=lambda x: x[1])
    # sweeps per lane, read back from the λ schedule: r retries leave
    # λ0 f^(r-1), so a lane valid at once (λ0 / f) took one sweep
    sweeps = float((torch.log(kb[3] / lam) / math.log(cfg.lambda_factor)
                    + 2).clamp(min=1).mean())
    rows["backward"] = dict(err=e, bound=backward_bound(2 * nv, nu, Hh, Bb,
                                                        sweeps))
    note(task, "backward", rows)
    if time_them:
        rows["backward"]["ms"] = cuda_ms(lambda: ops.backward(A, Bm, *l, lam,
                                                              cfg), 5)
        rows["backward"]["plain_ms"] = cuda_ms(lambda: ops.backward(
            A, Bm, *l, lam, cfg, plain=True), 1, 0)

    for name, row in rows.items():
        kind, tol = TOL[name]
        if name == "fd_jacobian":
            tol = fd_abs
        got = row["err"][1]
        check(math.isfinite(got) and got <= tol,
              f"{task.name} {name}: kernel vs plain error {got:.3e} > {kind} "
              f"{tol:.0e}")
        row["tol"] = f"{kind} {tol:.0e}"
    return rows


def golden_replay():
    z = np.load(GOLDEN)
    task = make_acrobot(device="cuda")
    f64 = dict(dtype=torch.float64, device="cuda")
    task = task.replace(
        weights=torch.tensor([0.0, 0.0, 0.001, 0.001, 0.01], **f64),
        weights_terminal=torch.tensor([100.0, 100.0, 1.0, 1.0, 0.01], **f64),
        keypoint_cfg=task.keypoint_cfg.replace(name="set_interval", min_N=5))
    traj, stats = ilqr.optimise(task, task.qpos_start, task.qvel_start,
                                torch.zeros((200, 1), **f64),
                                ILQRConfig(max_iterations=6, min_iterations=6))
    d_ctrl = float(np.abs(traj.ctrl.cpu().numpy() - z["ctrl"]).max())
    d_qpos = float(np.abs(traj.qpos.cpu().numpy() - z["qpos"]).max())
    d_cost = abs(stats.final_cost - float(z["final_cost"]))
    check(d_ctrl < CTRL_ATOL and d_qpos < QPOS_ATOL and d_cost < COST_ATOL,
          f"golden replay off: ctrl {d_ctrl:.2e} qpos {d_qpos:.2e} "
          f"cost {d_cost:.2e}")
    return dict(ctrl=d_ctrl, qpos=d_qpos, final_cost=d_cost,
                cost=stats.final_cost)


def main_path():
    task = make_acrobot(device="cuda")
    task = task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name="set_interval", min_N=1))
    qp, qv, tg = lanes.scenes(task, B, seed=0)
    U0 = torch.zeros((B, H, task.model.nu), dtype=torch.float64,
                     device="cuda")
    run = lanes.make_lane_phase_optimise(
        task, ILQRConfig(max_iterations=ITERS, min_iterations=ITERS), H)
    run(qp, qv, U0, tg)                                # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(qp, qv, U0, tg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    red = res.cost_reduction
    check(bool(torch.isfinite(red).all()), "main path: non-finite costs")
    mean_red = float(red.mean())
    check(0.0 < mean_red < 1.0, f"main path: mean cost reduction {mean_red}")
    for name in ops.KERNELS:
        check(launches[name] > 0, f"main path never launched {name}")

    # per-phase device times at the initial nominal
    cfg = ILQRConfig()
    qp0, qv0, tgl = qp.T.contiguous(), qv.T.contiguous(), tg.T.contiguous()
    U = U0.permute(1, 2, 0).contiguous()
    plan = lanes.si_plan(task, H)
    alphas = ilqr.default_alphas(cfg.num_parallel_rollouts, device="cuda")
    qpos, qvel, costs = ops.rollout(task, qp0, qv0, U, tgl)
    A, Bm = lanes.jacobians_si(task, plan, qpos, qvel, U, cfg.fd_eps)
    l = lanes.cost_expansion(task, qpos, qvel, U, tgl)
    lam = torch.full((B,), cfg.lambda_init, dtype=torch.float64,
                     device="cuda")
    k, K, *_ = ops.backward(A, Bm, *l, lam, cfg)
    old = costs.sum(0)
    phases = {
        "rollout": cuda_ms(lambda: ops.rollout(task, qp0, qv0, U, tgl), 3),
        "jacobians": cuda_ms(lambda: lanes.jacobians_si(
            task, plan, qpos, qvel, U, cfg.fd_eps), 3),
        "cost_expansion": cuda_ms(lambda: lanes.cost_expansion(
            task, qpos, qvel, U, tgl), 3),
        "bp": cuda_ms(lambda: ops.backward(A, Bm, *l, lam, cfg), 3),
        "fp": cuda_ms(lambda: lanes.forward_pass(
            task, qpos, qvel, U, k, K, alphas, tgl, old), 3),
    }

    # 3 iterations: kernel path against the plain path on the card
    cfg3 = ILQRConfig(max_iterations=3, min_iterations=3)
    r_k = lanes.make_lane_phase_optimise(task, cfg3, H)(qp, qv, U0, tg)
    r_p = lanes.make_lane_phase_optimise(task, cfg3, H, plain=True)(
        qp, qv, U0, tg)
    diff = (r_k.cost_reduction - r_p.cost_reduction).abs()
    agree = float((diff < 1e-4).double().mean())
    worst = torch.argsort(diff, descending=True)[:8]
    print(f"  3-it kernel vs plain: lanes within 1e-8 "
          f"{float((diff < 1e-8).double().mean()):.4f}, 1e-6 "
          f"{float((diff < 1e-6).double().mean()):.4f}, 1e-4 {agree:.4f}, "
          f"1e-2 {float((diff < 1e-2).double().mean()):.4f}; worst lanes "
          f"{worst.tolist()} kernel {r_k.cost_reduction[worst].tolist()} "
          f"plain {r_p.cost_reduction[worst].tolist()}", flush=True)
    check(agree >= 0.99, f"only {agree:.3f} of lanes agree with the plain "
                         "path within 1e-4")
    return dict(mean_cost_reduction=mean_red, wall_s=wall,
                solves_per_s=B / wall, launches=launches, phases_ms=phases,
                iterations_mean=float(res.num_iterations.double().mean()),
                plain_agree_3it=agree)


def cli():
    proc = subprocess.run(
        [sys.executable, "-m", "trajoptkp_tpu_torch.app", "--task", "acrobot",
         "--runMode", "Optimise_once", "--keypoint", "SI_1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"CLI failed:\n{proc.stdout}\n{proc.stderr}")
    if proc.returncode != 0:
        return None, proc.stdout
    line = proc.stdout.strip().splitlines()[-1]
    out = json.loads(line)
    check(math.isfinite(out["cost_reduction"]) and out["cost_reduction"] > 0,
          f"CLI cost reduction {out['cost_reduction']}")
    return line, proc.stdout


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    build_s, logs = build.build_all_timed()
    print(f"kernel build: {build_s:.1f} s (4 nvcc in parallel)", flush=True)
    for name, text in logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {name}: {ln.strip()}", flush=True)

    acro = make_acrobot(device="cuda")
    penta = make_pentabot(device="cuda")
    rows = check_kernels(acro, H, B, TOL["fd_jacobian"][1], time_them=True)
    prow = check_kernels(penta, PH, PB, PENTABOT_FD_ABS, time_them=False)
    for name in ops.KERNELS:
        print(f"check {name}: acrobot {rows[name]['tol']} err "
              f"{rows[name]['err'][1]:.3e}; pentabot {prow[name]['tol']} err "
              f"{prow[name]['err'][1]:.3e}", flush=True)

    gold = golden_replay()
    print(f"golden replay (kernel path): ctrl {gold['ctrl']:.2e} qpos "
          f"{gold['qpos']:.2e} final cost {gold['final_cost']:.2e}",
          flush=True)

    mp = main_path()
    print(f"main path acrobot SI_1 H={H} B={B} x{ITERS} it: mean cost "
          f"reduction {mp['mean_cost_reduction']:.4f}, {mp['solves_per_s']:.1f}"
          f" solves/s ({mp['wall_s']:.3f} s), phases ms "
          f"{json.dumps({k: round(v, 3) for k, v in mp['phases_ms'].items()})}"
          f", launches {json.dumps(mp['launches'])}, 3-it lanes agreeing "
          f"with plain {mp['plain_agree_3it']:.4f}", flush=True)

    cli_line, cli_out = cli()
    print(f"cli: {cli_line}", flush=True)
    if FAILED:
        raise RuntimeError(f"{len(FAILED)} checks failed: {FAILED}")

    kernels = []
    for name in ops.KERNELS:
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"trajoptkp_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": ops.REPLACES[name],
            "launches": mp["launches"][name],
            "max_abs_err": r["err"][0],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None,
            "tolerance": r["tol"], "pentabot_err": prow[name]["err"][0],
        })
    print("record " + json.dumps({
        "card": card, "build_s": build_s,
        "pentabot": {k: v["err"] for k, v in prow.items()},
        "golden": gold, "main_path": mp, "cli": cli_out,
        "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
