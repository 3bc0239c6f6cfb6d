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
    python -m trajoptkp_tpu_torch.bench_kernels --backward
    python -m trajoptkp_tpu_torch.bench_kernels --task pushing_no_clutter \
        --H 1000 --B 128 --kernels linesearch,ad_jacobian --reps 1

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
fd_jacobian), and the launch plans of the line search (K4: a warp or a
thread per lane, lanes a block, shared memory, waves) and of the exact
slot Jacobians (K5ad: primal entries per (slot, lane), slots a chunk).  `--rolled` builds and loads every library with its loops
rolled (TRAJOPT_ROLL_LOOPS), as the instances past build.ROLL_NV dofs are
built: a run with it and one without time the two builds of one instance
against each other.  `--backward` times the backward pass (K7) alone at
each main path's shape (BACKWARD_SHAPES) on `backward_inputs` (every lane
valid at its first sweep, so a call is one sweep and 1 + bp_rounds
launches), with its launch geometry.  `--marks` without `--backward`
builds the line search with its phase marks (TRAJOPT_WARP_MARKS,
build.WARP_MARKS) and gives the SM cycles a step of its first lane spends
in each of WARP_PHASES over one call.  With `--backward --marks` K7 is
built with its
phase marks (TRAJOPT_BP_MARKS, build.BP_MARKS: a library of its own, its
times the marked kernel's) and each shape also gives the SM cycles a step
spends in each phase (BP_PHASES, one call); with `--threads` each shape
where a block owns a lane is also timed at those block sizes, each held
bit for bit against the twin first (`bitwise`).  To
compare two trees on one card, run this file once per tree inside one job,
with PYTHONPATH set to the tree under test, in the order parent, change,
change, parent; or, against a tree whose C entries of K3 and K5 take no
launch plan (a thread per scene, a thread per (slot, scene)),
`--against OTHER/trajoptkp_tpu_torch/kernels/_build` (its libraries of
the task's instance built there first) times both trees' K3, K4, K5 and
K5ad (those of `--kernels`) alternately in this one process, `--pairs`
times, and holds their outputs bit for bit.  `--servo` times the task's
initial-controls servo alone (`--rounds` runs; run it once per tree, with
PYTHONPATH set to the tree, to compare the servo's K3 launches at H = 1).  `--kernels` naming only
rollout, fd_jacobian or cost_expansion skips the gains, the backward pass
and its sweeps (no K5ad or K7 library is built). """

import argparse
import contextlib
import ctypes
import json
import subprocess

import numpy as np
import torch

from trajoptkp_tpu_torch.config.loader import make_task
from trajoptkp_tpu_torch.kernels import build, ops
from trajoptkp_tpu_torch.solver import ilqr, lanes
from trajoptkp_tpu_torch.utils import linalg


# K7's (nx, nu, H, B) on each main path: the open-loop cells, the walker's
# sync MPC replan at one and 128 episodes, the async push_ncl planner
BACKWARD_SHAPES = {
    "acrobot": (4, 1, 500, 512), "reaching": (14, 7, 1500, 128),
    "push_ncl": (20, 7, 1000, 128), "box_sweep": (26, 7, 1500, 128),
    "push_lcl": (38, 7, 1000, 128), "walker_b1": (18, 6, 40, 1),
    "walker_b128": (18, 6, 40, 128), "push_ncl_planner": (20, 7, 50, 1)}


def backward_inputs(nx, nu, H, B, seed, device, retries=False):
    """(A, Bm, l_x, l_xx, l_u, l_uu, λ) for the backward pass from a numpy
    seed: A a contraction (0.95 I plus noise, so V stays bounded over any
    horizon), l_xx and l_uu positive definite.  With `retries` the lanes
    take turns at l_uu shifted by 0, -0.5, -5 and -100 I: valid at the
    first λ (0.1), after one or two retries, or never (λ-exit), and a lane
    made valid by λ 1 turns invalid again as its λ falls, so the coupled
    loop runs all its rounds."""
    r = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(r.standard_normal(shape)).to(device)

    def gram(M):                   # M M^T / n per (t, b), positive definite
        return torch.einsum("hikb,hjkb->hijb", M, M) / M.shape[1]

    f64 = dict(dtype=torch.float64, device=device)
    eye_x = torch.eye(nx, **f64)[None, :, :, None]
    eye_u = torch.eye(nu, **f64)[None, :, :, None]
    A = 0.95 * eye_x + 0.1 * draw(H, nx, nx, B) / nx
    Bm = 0.05 * draw(H, nx, nu, B)
    l_x = draw(H, nx, B)
    l_xx = gram(draw(H, nx, nx, B))
    l_u = draw(H, nu, B)
    l_uu = gram(draw(H, nu, nu, B)) + 0.1 * eye_u
    if retries:
        shift = torch.tensor([0.0, -0.5, -5.0, -100.0], **f64)[
            torch.arange(B) % 4]
        l_uu = l_uu + shift * eye_u
    lam = torch.full((B,), ilqr.ILQRConfig().lambda_init, **f64)
    return tuple(x.contiguous() for x in (A, Bm, l_x, l_xx, l_u, l_uu, lam))


class _ExactSqrtTorch:
    """torch, with a correctly rounded square root of CPU tensors."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def sqrt(x):
        if x.device.type != "cpu":
            return torch.sqrt(x)
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(x.numpy()))


@contextlib.contextmanager
def exact_cpu_sqrt():
    """The twins' Cholesky (utils/linalg.py, the one square root of K7's
    twin) with numpy's square root of CPU tensors, the correctly rounded
    one that the card computes, while the block runs: torch's vectorised
    CPU sqrt rounds some doubles an ulp away (`cpu_sqrt_off_share`).  Only
    that module's name `torch` is replaced, and put back after."""
    linalg.torch = _ExactSqrtTorch()
    try:
        yield
    finally:
        linalg.torch = torch


def cpu_sqrt_off_share(n=1_000_000, seed=0):
    """The share of n doubles, uniform in [0, 1) from a numpy seed, whose
    square root torch rounds otherwise on this host's CPU than numpy's
    correctly rounded one."""
    x = np.random.default_rng(seed).random(n)
    return float((torch.sqrt(torch.from_numpy(x)).numpy()
                  != np.sqrt(x)).mean())


# the phases of a step of the cooperative step (csrc/warp_step.cuh)
WARP_PHASES = ("control law", "FK, RNE, narrow phase", "CRBA, forces, rows",
               "a0", "Newton products", "Newton gradient and H",
               "Newton solves", "Newton step length", "constraint force",
               "mass-matrix solve, Euler")


def warp_marks(tag, call):
    """SM cycles a step of block 0's first lane of K4 spends in each of
    WARP_PHASES over one call(), from a build with build.WARP_MARKS."""
    read = build.load("linesearch", tag).trajopt_warp_marks_read
    read.argtypes = [ctypes.c_void_p]
    marks = (ctypes.c_ulonglong * 16)()
    torch.cuda.synchronize()
    read(marks)                                # zero the earlier calls' sums
    call()
    torch.cuda.synchronize()
    read(marks)
    steps = max(1, marks[15])
    return {name: marks[i] / steps for i, name in enumerate(WARP_PHASES)}


# the phases of a K7 step between its lane barriers (csrc/backward.cu)
BP_PHASES = ("W, g", "Q_ux, Q_uu", "solves", "V update")


def bp_marks(nx, nu, call):
    """SM cycles a step of block 0's first lane spends in each of BP_PHASES
    over one call(), from K7's phase marks (a build with build.BP_MARKS)."""
    read = build.load("backward", f"nx{nx}_nu{nu}").trajopt_bp_marks_read
    read.argtypes = [ctypes.c_void_p]
    marks = (ctypes.c_ulonglong * 5)()
    torch.cuda.synchronize()
    read(marks)                                # zero the earlier calls' sums
    call()
    torch.cuda.synchronize()
    read(marks)
    steps = max(1, marks[0])
    return {name: marks[i + 1] / steps for i, name in enumerate(BP_PHASES)}


def same_values(a, b):
    """Equal element for element, NaN where the other is NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def bench_threads(nx, nu, inputs, threads, reps, rounds):
    """K7 at (nx, nu) with its block size set to each of `threads` that
    the kernel takes (a block owning a lane): whether it equals the twin
    bit for bit on `backward_inputs` with λ retries, and its ms per call
    of every round on `inputs`."""
    cfg = ilqr.ILQRConfig()
    base = ops.backward_geometry(nx, nu)
    held = backward_inputs(nx, nu, 12, 5, seed=nx, device="cuda",
                           retries=True)
    plain = ops.backward(*held, cfg, plain=True)
    out = {}
    for t in threads:
        if base.lanes != 1 or not (
                ops.backward_solver_threads(nx) + 32 <= t <= ops.BP_THREADS[1]
                and t % 32 == 0):
            continue
        g = base._replace(threads=t)
        out[t] = {
            "bitwise": all(same_values(a, b) for a, b in zip(
                ops.backward(*held, cfg, geometry=g), plain)),
            "ms": [event_ms(lambda: ops.backward(*inputs, cfg, geometry=g),
                            reps) for _ in range(rounds)]}
    return out


def bench_backward(reps, rounds, marks=False, threads=()):
    """K7 alone at BACKWARD_SHAPES: geometry, ms per call of every round,
    sweeps per lane, with `marks` the cycles of a step's phases, and at
    each block size of `threads` (bench_threads)."""
    cfg = ilqr.ILQRConfig()
    out = {}
    for name, (nx, nu, H, B) in BACKWARD_SHAPES.items():
        inputs = backward_inputs(nx, nu, H, B, seed=0, device="cuda")
        info = {}
        ops.backward(*inputs, cfg, info=info)
        out[name] = {
            "nx": nx, "nu": nu, "H": H, "B": B,
            "geometry": ops.backward_geometry(nx, nu)._asdict(),
            "launches_per_call": 1 + ilqr.bp_rounds(cfg),
            "sweeps_per_lane": 1 + int(info["rounds"]),
            "ms": [event_ms(lambda: ops.backward(*inputs, cfg), reps)
                   for _ in range(rounds)]}
        if marks:
            out[name]["cycles_per_step"] = bp_marks(
                nx, nu, lambda: ops.backward(*inputs, cfg))
        if threads:
            out[name]["threads"] = bench_threads(nx, nu, inputs, threads,
                                                 reps, rounds)
        del inputs
    return out


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


def _same(a, b) -> bool:
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def against(other, task, qp0, qv0, qpos, qvel, U, k, K, alphas, tgl, times,
            pairs, reps, only=None):
    """This tree's K3, K4, K5 and K5ad (those of `only`) against another
    checkout's libraries of the same instance, timed alternately in one
    process (`pairs` pairs, the order swapped every pair, `reps` launches
    each) on the same inputs, with their outputs compared bit for bit (NaN
    where NaN).  Both sides call their C entries directly on buffers
    allocated once, so that neither time holds a wrapper's checks or
    allocations.  `other` is that checkout's kernels/_build, built there by
    its own kernels/build.py: a tree whose K3 and K5 C entries take no
    launch plan (K3 a thread per scene, rollout.cu; K5 a thread per (slot,
    scene)) and whose K4 and K5ad entries take this tree's arguments.  This
    tree's K3 is the line search's open loop where the instance has
    constraint rows."""
    from trajoptkp_tpu_torch import sass_counts

    ka = ops.kernel_args(task, U.device)
    tag = ka.tag
    stag = build.step_shared().get(tag, tag)
    names = [n for n in ("rollout", "linesearch", "fd_jacobian",
                         "ad_jacobian") if only is None or n in only]
    theirs_lib = {"rollout": ("rollout", tag),
                  "linesearch": ("linesearch", tag),
                  "fd_jacobian": ("fd_jacobian", stag),
                  "ad_jacobian": ("ad_jacobian", stag)}
    paths = sass_counts.built_in(other, [theirs_lib[n] for n in names])
    sms = torch.cuda.get_device_properties(U.device).multi_processor_count
    topo = build.instance_tables()[tag]
    H, B, nA = U.shape[0], U.shape[-1], alphas.shape[0]
    g3 = ops.linesearch_geometry(topo, 1, B, sms)
    ours_lib = dict(theirs_lib, rollout=("linesearch" if g3.warp
                                         else "rollout", tag))
    build.build({ours_lib[n] for n in names})
    f64 = dict(dtype=torch.float64, device=U.device)
    null = ctypes.c_void_p(None)

    def entry(lib, symbol, *args):
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = [type(a) for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call():
            err = fn(*args, ctypes.c_void_p(
                torch.cuda.current_stream().cuda_stream))
            if err != 0:
                raise RuntimeError(f"{symbol}: cudaError {err}")
        return call

    def mine(name, symbol, *args):
        return entry(build.library_path(*ours_lib[name]), symbol, *args)

    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    nK = times.shape[0]
    two = lambda *shape: [torch.empty(shape, **f64)  # noqa: E731
                          for _ in range(2)]
    calls = {}
    if "rollout" in names:
        r = [two(H + 1, ka.nq, B), two(H + 1, ka.nv, B), two(H, B)]
        res = [tuple(x[i] for x in r) for i in range(2)]
        head = (p(ka.model_buf), p(ka.task_buf), p(qp0), p(qv0), p(U))
        hw = (ctypes.c_int(H), ctypes.c_int(B))
        theirs = entry(paths[theirs_lib["rollout"]], f"trajopt_rollout_{tag}",
                       *head, p(tgl), *map(p, res[0]), *hw)
        if g3.warp:
            q, v, c = map(p, res[1])
            ours = mine("rollout", f"trajopt_linesearch_{tag}", *head, null,
                        null, null, p(tgl), q, v, null, c, ctypes.c_int(H),
                        ctypes.c_int(1), ctypes.c_int(B),
                        ctypes.c_int(g3.threads), ctypes.c_int(g3.lanes),
                        ctypes.c_int(g3.smem_bytes))
        else:
            ours = mine("rollout", f"trajopt_rollout_{tag}", *head, p(tgl),
                        *map(p, res[1]), *hw)
        calls["rollout"] = (theirs, ours, res)
    if "linesearch" in names:
        r = [two(H + 1, ka.nq, nA, B), two(H + 1, ka.nv, nA, B),
             two(H, ka.nu, nA, B), two(H, nA, B)]
        res = [tuple(x[i] for x in r) for i in range(2)]
        g = ops.linesearch_geometry(topo, nA, B, sms)
        args = (p(ka.model_buf), p(ka.task_buf), p(qpos), p(qvel), p(U),
                p(k), p(K), p(alphas), p(tgl))
        tail = (ctypes.c_int(H), ctypes.c_int(nA), ctypes.c_int(B),
                ctypes.c_int(g.threads), ctypes.c_int(g.lanes),
                ctypes.c_int(g.smem_bytes))
        calls["linesearch"] = (
            entry(paths[theirs_lib["linesearch"]], f"trajopt_linesearch_{tag}",
                  *args, *map(p, res[0]), *tail),
            mine("linesearch", f"trajopt_linesearch_{tag}", *args,
                 *map(p, res[1]), *tail), res)
    slot_args = (p(ka.model_buf), p(qpos), p(qvel), p(U), p(times),
                 ctypes.c_longlong(1), ctypes.c_longlong(0), null,
                 ctypes.c_int(0))
    if "fd_jacobian" in names:
        J = two(nK, ka.sv.nx, ka.sv.nx + ka.nu, B)
        g5 = ops.fd_geometry(build.instance_tables()[stag], nK, B, sms)
        eps = ctypes.c_double(ilqr.ILQRConfig().fd_eps)
        sym = f"trajopt_fd_jacobian_{stag}"
        calls["fd_jacobian"] = (
            entry(paths[theirs_lib["fd_jacobian"]], sym, *slot_args, eps,
                  p(J[0]), ctypes.c_int(nK), ctypes.c_int(B)),
            mine("fd_jacobian", sym, *slot_args, eps, p(J[1]),
                 ctypes.c_int(nK), ctypes.c_int(B), ctypes.c_int(g5.threads),
                 ctypes.c_int(g5.lanes), ctypes.c_int(g5.smem_bytes)),
            [(j,) for j in J])
    if "ad_jacobian" in names:
        J = two(nK, ka.sv.nx, ka.sv.nx + ka.nu, B)
        entries = ops.ad_primal_entries(build.instance_tables()[stag])
        chunk = ops.ad_chunk(entries, nK, B)
        prim = torch.empty((max(chunk * entries * B, 1),), **f64)
        sym = f"trajopt_ad_jacobian_{stag}"
        args = (*slot_args, ctypes.c_void_p(prim.data_ptr() if chunk
                                            else None),
                ctypes.c_int(entries), ctypes.c_int(chunk))
        calls["ad_jacobian"] = (
            entry(paths[theirs_lib["ad_jacobian"]], sym, *args, p(J[0]),
                  ctypes.c_int(nK), ctypes.c_int(B)),
            mine("ad_jacobian", sym, *args, p(J[1]), ctypes.c_int(nK),
                 ctypes.c_int(B)), [(j,) for j in J])
    out = {}
    for name, (theirs, ours, res) in calls.items():
        theirs()
        ours()
        same = all(_same(a, b) for a, b in zip(*res))
        ms = {"other": [], "this": []}
        for i in range(pairs):
            order = (("other", theirs), ("this", ours))
            for who, fn in (order if i % 2 == 0 else order[::-1]):
                ms[who].append(event_ms(fn, reps))
        out[name] = dict(bitwise_equal=same, **ms)
    return out


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


def bench_servo(name, H, B, rounds, profile=False):
    """Wall seconds of `rounds` runs of a task's initial-controls servo
    (`bench_inputs`: for the pushing tasks the setup servo and the init
    servo over H, a K3 launch at H = 1 and an fk_bias launch a step), each
    from the scenes to a synchronize, the first after one warm-up run; with
    `profile` one more run under torch.profiler prints its 15 kernels of
    most device time and its CPU-side totals."""
    import time

    task = make_task(name, device="cuda")
    bench_inputs(task, H, B)
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bench_inputs(task, H, B)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            bench_inputs(task, H, B)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=15), flush=True)
        print(prof.key_averages().table(sort_by="cpu_time_total",
                                        row_limit=15), flush=True)
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
    ap.add_argument("--backward", action="store_true",
                    help="K7 alone at every main path's shape")
    ap.add_argument("--marks", action="store_true",
                    help="K7 (with --backward) or K4 with its phase marks")
    ap.add_argument("--threads", default="",
                    help="with --backward: also at these block sizes "
                    "(comma-separated)")
    ap.add_argument("--against", metavar="BUILD_DIR",
                    help="also time K4 and K5ad against another "
                    "checkout's libraries, alternately (`against`)")
    ap.add_argument("--pairs", type=int, default=10,
                    help="with --against: pairs of timings")
    ap.add_argument("--servo", action="store_true",
                    help="time the task's initial-controls servo alone")
    ap.add_argument("--profile", action="store_true",
                    help="with --servo: the device time of its kernels by "
                    "name (torch.profiler) over one more run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: no CUDA device is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    if args.backward:
        build.BP_MARKS = args.marks
        logs = build.build(tuple(("backward", b)
                                 for b in build.instance_names()[1]))
        nvcc = {name: [ln.strip() for ln in text.splitlines()
                       if "registers" in ln or "spill" in ln
                       or "done after" in ln] for name, text in logs.items()}
        print(json.dumps({"label": args.label, "card": card, "reps":
                          args.reps, "marks": args.marks, "nvcc": nvcc,
                          "backward": bench_backward(
                              args.reps, args.rounds, args.marks,
                              [int(t) for t in args.threads.split(",")
                               if t])}),
              flush=True)
        return
    if args.servo:
        print(json.dumps({"label": args.label, "task": args.task, "H": args.H,
                          "B": args.B, "card": card,
                          "servo_s": bench_servo(args.task, args.H, args.B,
                                                 args.rounds, args.profile)}),
              flush=True)
        return
    if args.rolled:
        build.ROLL_NV = 0
    build.WARP_MARKS = args.marks
    task = make_task(args.task, device="cuda")
    task = task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name="set_interval", min_N=1))
    cfg = ilqr.ILQRConfig()
    H, B = args.H, args.B
    qp0, qv0, tgl, U = bench_inputs(task, H, B)
    plan = lanes.si_plan(task, H)
    alphas = ilqr.default_alphas(cfg.num_parallel_rollouts, device="cuda")
    qpos, qvel, _ = ops.rollout(task, qp0, qv0, U, tgl)
    only = args.kernels.split(",") if args.kernels else None
    k = K = A = Bm = l = lam = sweeps = None
    if only is None or not set(only) <= {"rollout", "fd_jacobian",
                                         "cost_expansion"}:
        # the gains K4 runs on and the backward pass's inputs
        A, Bm = lanes.jacobians_si(task, plan, qpos, qvel, U,
                                   lanes.slot_jacobians(task, "ad"))
        l = lanes.cost_expansion(task, qpos, qvel, U, tgl)
        lam = torch.full((B,), cfg.lambda_init, dtype=torch.float64,
                         device="cuda")
        k, K = ops.backward(A, Bm, *l, lam, cfg)[:2]
        sweeps = bp_sweeps_per_lane(
            task, plan, qpos, qvel, U, l, lam, cfg,
            ("ad", "fd") if only is None or "fd_jacobian" in only
            else ("ad",))
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
    if hasattr(ops, "mpc_apply") and (only is None or "mpc_apply" in only):
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
    marks = None
    if args.marks and (only is None or "linesearch" in only):
        tag = ops.kernel_args(task, U.device).tag
        if ops.linesearch_geometry(build.instance_tables()[tag],
                                   alphas.shape[0], B).warp:
            marks = warp_marks(tag, calls["linesearch"])
    topo_tag = ops.kernel_args(task, U.device).tag
    topo = build.instance_tables()[topo_tag]
    nA = alphas.shape[0]
    ls = ops.linesearch_geometry(topo, nA, B)
    entries = ops.ad_primal_entries(topo)
    plans = {"linesearch": dict(ls._asdict(), waves=ls.waves(nA, B)),
             "ad_jacobian": {"entries": entries, "chunk": ops.ad_chunk(
                 entries, plan.times.shape[0], B)}}
    if hasattr(ops, "fd_geometry"):
        plans["rollout"] = ops.linesearch_geometry(topo, 1, B)._asdict()
        plans["fd_jacobian"] = ops.fd_geometry(
            build.instance_tables()[build.step_shared()[topo_tag]],
            plan.times.shape[0], B)._asdict()
    pair = None
    if args.against:
        import pathlib

        pair = against(pathlib.Path(args.against), task, qp0, qv0, qpos,
                       qvel, U, k, K, alphas, tgl, plan.times, args.pairs,
                       args.reps, only)
    print(json.dumps({"label": args.label, "task": args.task, "H": H, "B": B,
                      "reps": args.reps, "rolled": args.rolled,
                      "card": card, "ms": ms, "plans": plans,
                      "linesearch_cycles_per_step": marks,
                      "bp_sweeps_per_lane": sweeps, "against": pair}),
          flush=True)


if __name__ == "__main__":
    main()
