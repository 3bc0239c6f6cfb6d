#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernels from kernels/csrc (one nvcc per library and model
instance, all in parallel) and holds each against its plain PyTorch twin
on the card: acrobot at its main path's shapes, pentabot (folded, so that
its capsule pairs touch), reaching
(panda, joint limits: the constraint solve inside the step), push_ncl (panda
pushing a free cylinder: the contact rows and narrow phase inside the step
as well) and the walker (three joints on its torso, plane-capsule and
capsule-capsule rows; with the MPC replan's apply step, K8) at a smaller
size, half of reaching's lanes started at their joint limits, push_ncl's
from its servo with all three contact pairs touching and the walker's
pressed into the floor or folded with a shin in the torso (the contact rows
K2b and the constraint solve K2a run inside the step of the rollout,
line-search, Jacobian and apply kernels); the exact slot Jacobians (K5ad:
the step in dual numbers with the implicit constraint tangents K2c) at
shared slots, at per-lane slots and into an iterative_error cache; the
servo's fk_bias is held against its twin too, and the cost expansion (K6)
bit for bit at every model.  The backward pass is also held against its
twin summed in another order (`sum_contract`) on the card and on the CPU,
and in its own order on the CPU with a correctly rounded sqrt.  The
`bp_instances` phase holds the backward pass (K7, a thread block per lane)
at every instance built, at one lane and at five, through λ retries and
λ-exits, bit for bit, and prints each instance's launch geometry, shared
memory, registers and nvcc seconds.  The `step_instances` phase does the
same for the rollout (K3, a warp per scene: the line search's kernel in
its open loop where the model has constraint rows), the line search (K4,
a warp per lane over the cooperative step of warp_step.cuh where the
model has constraint rows), central FD (K5, a warp per (slot, column,
scene) item where the model has rows) and the exact slot Jacobians (K5ad,
a primal pass per (slot, lane) and a tangent pass per column, one pass
where the model has no primal entries) at every model instance, at one
scene and at five (K3 also in blocks of two scenes, K4 of four lanes, K5
of three items, the last block part full; K5 and K5ad at shared slot
times, per-lane slots with live counts and into the iterative_error
cache, K5ad with all slots or one a chunk), its twins beside the build.
The `box` phase holds the box tasks' kernels (box_sweep and threeD_push: a
free box in the state with its rotations, plane-box and cylinder-box rows
inside the step) against their twins bit for bit at H=100 B=64 (K3, K4,
K5ad and K5 at shared and per-lane slots, K6, fk_bias; K7 within its bar),
with the box flat, tilted, pressed in, around the pusher's end point and
beside a pusher pressed into the table.  The `clutter` phase holds
push_lcl's and push_ccl's kernels (one instance: nv 31, 114 rows, nx 38,
its loops rolled) against their twins bit for bit at H=6 B=16 (K7 within
its bar): K3, K4, K5ad in its three slot modes, K5, K6, fk_bias, and K9a,
K5ad at per-lane slots and K9b at the tasks' AJ_1_100, with the objects
pressed into the table, into each other and into the pusher, every one
of the 15 pairs touching.  It replays the
acrobot SI_5 H=200 golden solve on the kernel path, then drives the main
paths with launch counts: acrobot SI_1 (H=500, 512 scenes), reaching SI_1
(H=1500, 128 scenes) and push_ncl SI_1 (H=1000, 128 scenes from the task's
scene generator, started by its setup and init servo) and box_sweep SI_1
(H=1500, 128 scenes of the JAX CLI's generic generator, started by its
init servo) through
`make_lane_phase_optimise`, and push_lcl SI_1 (`main_clutter`: H=1000,
128 scenes of its generator, started by its setup and init servos),
10 iterations each but reaching 3, push_ncl, box_sweep and push_lcl 2
(MAIN_ITERS; 10 in `--deep`), and walker_run sync MPC through the
campaign entry point (`sync_mpc_horizon_sweep`: H=40, 50 replans of one
iteration and one applied control (200 in `--deep`), one episode and 128
episodes, and H=20 and 80), float64.  Three iterations of box_sweep's
path are compared with the plain path on the card (H=20, 64 lanes); the
open-loop kernels are timed at
reaching's, push_ncl's and box_sweep's full shapes, the push_ncl and
box_sweep servos' first steps and their fk_bias are held against the plain
servo at their own 128 lanes (`check_servo`), K9a and K9b are held and
timed at box_sweep's full shape with its CLI method (AJ_1_1000), each phase
of a walker replan is timed.  The keypoint kernels (K9a, K9b, K9c and K5ad at per-lane slots) are
held against their twins bit for bit in the `keypoints` phase (acrobot
VC/AJ/AA/IE, pentabot AA, reaching and push_ncl AJ_5_100, the walker VC, a
slot budget that overflows, and reaching's and push_ncl's full shapes), and
the `main_adaptive` phase drives acrobot AJ_1_50, VC_1_200 and IE_1_50
(H=500, 512 scenes) and reaching AJ_5_100 (H=1500, 128 scenes) through
`make_lane_phase_optimise` with launch counts, 3 acrobot iterations each
against the keypoint kernels' twins.  The `main_async` phase runs asynchronous MPC in real
time (`mpc/async_mpc.py`: a planner thread replanning one iteration at a
time on its own CUDA stream, the actor stepping through K3 on another):
push_ncl SI_1 over 3 scenes of the async campaign's generator (5 in
`--deep`), 500 steps
each at 125 Hz (`async_mpc_campaign`), and one walker_run episode of 2000
steps at 200 Hz, with exact launch counts and a planner that lowers its
plan's cost, and first holds one planner step (at H=5), the actor's step
and its gravity hold against their twins, bit for bit, and each kernel
phase of a push_ncl planner step at its own shape (H=50, B=1: the generic
solve, whose Jacobians at the default deriv_mode are K5's central FD; run
while the CLI processes run).  The CLI solves the five open-loop tasks
(box_sweep and threeD_push too) with their own keypoint methods, the
clutter tasks at H=100 (CLI_CLUTTER_H), acrobot
with IE_1_50 and with `--deriv_mode ad`, runs the walker's
`Generate_syncronus_mpc_data --horizon 40`, push_ncl's
`Generate_asynchronus_mpc_data --num_scenes 3 --keypoint SI_1` and
acrobot's `MPC_until_completion`, the twelve processes side by side.

`python3 chip_smoke.py --deep` runs the deep agreement holds and the full
depths alone, as a job of its own (`deep`; `--deep --phases a,b` a subset
of main_paths, full_shapes, clutter_full_shape, keypoints, mpc, async):
the acrobot, reaching,
push_ncl, box_sweep and push_lcl main paths at 10 iterations, with 3
iterations of the kernel path against the plain path (acrobot H=500
B=512, reaching H=RH3, push_ncl H=UH3 and push_lcl H=CH3 at B=64);
reaching's, push_ncl's, box_sweep's and push_lcl's kernels against their
twins at their main paths' full shapes on their initial nominals
(`full_shape`; push_lcl's K3, K4 and K5ad over the first CLUTTER_STEPS
steps and slots of all 128 lanes, its K6, K7 and fk_bias whole); the
keypoint kernels at reaching's and push_ncl's full shapes, push_lcl's
campaign method AJ_5_100 and acrobot VC_1_200's 3 iterations against the
whole plain path; the walker's sync MPC sweep at 200 replans, its first
MPC_PLAIN_REPLANS MPC replans and six acrobot MPC replans against the
plain path, and each kernel phase of the walker's first replan of 128
episodes against its twin; async MPC over 5 push_ncl scenes.  Its build
compiles the libraries the default run leaves to their first launch
(build.LAZY) too.  It prints a `record` line and no result line.

Prints the card's name and power limit, the kernel build time, the seconds
of each phase and of the whole script, K3 and K5 per launch on each main
path (the rollout phases, the walker's replan, the async planner's
phases), a `record` line with every measurement, one
`{"kernels": [...]}` line (one entry per kernel and model) and, last,
`{"ok": true, "device": {...}}`.  Any failed check is printed as it happens
and makes the script exit non-zero at the end without a result; it also
fails where no CUDA device is present.  The MPC campaigns write their
`mpc_horizons.csv` and `async_mpc.csv` under chip_smoke_out/mpc/.

The plain halves of the holds launch no kernel and run while the kernels
build: the twins of the clutter, pentabot, reaching, walker and box
checks and the plain half of box_sweep's 3-iteration hold in processes of
this script
(`--plain-check-worker NAMES PATH`, CHECK_WORKERS, each result saved to
PATH), which the script waits for and stops; in `--deep`, the acrobot and
reaching 3-iteration holds and acrobot's MPC holds in this process and the
walker's MPC hold in a second one (`--plain-mpc-worker PATH`).

`--phases a,b` runs a subset (build, bp_instances, step_instances,
acrobot, pentabot,
reaching, push,
walker, box, clutter, keypoints, golden, main_acrobot, main_reaching,
main_push, main_box_sweep, main_clutter, main_mpc, main_adaptive,
main_async, cli) while
developing; a subset never prints a result.
"""

import argparse
import contextlib
import json
import math
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from trajoptkp_tpu_torch.dynamics.collision import geom_pose
from trajoptkp_tpu_torch.dynamics.contact import (ALPHA_LADDER, NEWTON_ITERS,
                                                  contact_constants,
                                                  contact_slots,
                                                  contacts_active,
                                                  limit_constants,
                                                  limits_active)
from trajoptkp_tpu_torch.dynamics.fk import forward_kinematics
from trajoptkp_tpu_torch.dynamics.model import FREE, HINGE, SLIDE, Data
from trajoptkp_tpu_torch.dynamics.step import step_state
from trajoptkp_tpu_torch import app, sass_counts
from trajoptkp_tpu_torch.bench_kernels import (backward_inputs,
                                               cpu_sqrt_off_share,
                                               exact_cpu_sqrt)
from trajoptkp_tpu_torch.bench.campaigns import (async_mpc_campaign,
                                                 async_scenes, episode_starts,
                                                 sync_mpc_horizon_sweep)
from trajoptkp_tpu_torch.config.loader import make_task
from trajoptkp_tpu_torch.kernels import build, ops
from trajoptkp_tpu_torch.mpc import native_executor
from trajoptkp_tpu_torch.mpc import sync as mpc_sync
from trajoptkp_tpu_torch.mpc.async_mpc import AsyncMPC
from trajoptkp_tpu_torch.solver import ilqr, lanes
from trajoptkp_tpu_torch.solver.ilqr import ILQRConfig
from trajoptkp_tpu_torch.state.statevector import to_tangent
from trajoptkp_tpu_torch.tasks import manipulation, pushing
from trajoptkp_tpu_torch.tasks.base import control_limits
from trajoptkp_tpu_torch.tasks.locomotion import make_walker
from trajoptkp_tpu_torch.tasks.reaching import make_reaching
from trajoptkp_tpu_torch.tasks.toys import make_acrobot, make_pentabot

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "acrobot_si5_h200.npz")

H, B, ITERS = 500, 512, 10          # the acrobot main path
# the iterations of the slow main paths in the default run, cut from ITERS
# to pay for the clutter phases (their per-iteration times are the same);
# `--deep` runs each at ITERS
MAIN_ITERS = {"reaching": 3, "push_ncl": 2, "box_sweep": 2, "push_lcl": 2}
LONG_CALL_MS = 500.0                # phase_ms: a call this long is timed once
RH, RB = 1500, 128                  # the reaching main path
UH, UB = 1000, 128                  # the push_ncl main path
PH, PB = 100, 64                    # pentabot, reaching and push check size
BH, BB = 1500, 128                  # the box_sweep main path
# the clutter tasks (level of pushing.make_pushing by instance name): their
# kernel check (its twins beside the build: the plain push_lcl rollout of
# 8 steps at 16 lanes took 105 s there, PERF.md) and push_lcl's
# 3-iteration hold in `--deep`
CLUTTER = {"push_lcl": 3, "push_ccl": "constrained"}
CH, CB = 6, 16
CH3 = 10
# push_lcl's full-shape hold in `--deep` (clutter_full_shape): K3 and K4
# step by step over the first CLUTTER_STEPS steps of all UB lanes, K5ad at
# as many slots (the twin in chunks of CLUTTER_CHUNK slots: it steps 45
# dual copies of each (slot, lane)); K6, K7 and fk_bias whole
CLUTTER_STEPS = 50
CLUTTER_CHUNK = 10
# the clutter CLI runs' horizon: a push_lcl step takes ~14 ms of one
# thread, and the setup servo's 1000 steps come first
CLI_CLUTTER_H = 100
# kernel-vs-plain 3-iteration solve horizons of the earlier slices' main
# paths and their full-shape holds (stepwise_check), in the `--deep` job (a
# plain reaching step at 64 lanes takes ~170 ms on an H100); box_sweep's
# 3-iteration hold in the default run
RH3 = 100
UH3 = 40
BH3 = 20
SERVO_CHECK = 10                    # servo steps held against the plain servo
# push_lcl's: a plain servo step at nv 31 takes seconds
SERVO_CHECKS = {"push_lcl": 3}
WH, WB = 20, 16                     # walker check size
MH, MB = 40, 128                    # walker MPC: make_walker's mpc_horizon,
#                                     and the episodes of the batched run
# replans per episode: the JAX campaign's 200 (DEEP_REPLANS) in `--deep`,
# cut to 50 in the default run to pay for the clutter phases (the CLI's
# walker run keeps 200)
N_REPLANS, DEEP_REPLANS = 50, 200
SWEEP = (20, 40, 80)                # horizons of the sweep, B = 1
# walker replans held against the plain path in the `--deep` job: a plain
# walker replan is host-bound twin launches (its rollout and line search
# step the plain walker 40 times each; K5ad's forward-mode twin is one dual
# step over all slots), 110-150 s beside the build, where it runs in a
# process of its own (plain_mpc_worker)
MPC_PLAIN_REPLANS = 2
MPC_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chip_smoke_out", "mpc")
# push_ncl's check inputs (from its kernel servo), handed to the process
# that runs their twins
PUSH_INPUTS = os.path.join(MPC_OUT, "push_inputs.pt")
# async MPC (main_async), real time: push_ncl SI_1 over the campaign's
# scenes, the walker one MPC_until_completion-style episode
# (the campaign's 5 scenes in `--deep`, 3 in the default run)
ASYNC_PUSH_SCENES, DEEP_PUSH_SCENES, ASYNC_PUSH_STEPS = 3, 5, 500
ASYNC_WALKER_STEPS = 2000
ASYNC_MIN_PLANS = 10                # plans published per episode, at least
# the whole async planner step (`AsyncMPC.replan`) held against its
# all-twin path at this horizon: a plain push_ncl or walker step is ~0.3-0.5
# s of the card's time, and a plain replan ~2H + 1 of them.  The kernels
# are held at the planners' own shapes too: push_ncl's at H=50 B=1 phase by
# phase (main_async's hold, run beside the CLI), the walker's at H=40 B=1
# in main_mpc's kernel path against the plain path
ASYNC_HOLD_H = 5
PHASES = ("build", "bp_instances", "step_instances", "acrobot", "pentabot", "reaching", "push", "walker",
          "box", "clutter", "keypoints", "golden", "main_acrobot",
          "main_reaching", "main_push", "main_box_sweep", "main_clutter",
          "main_mpc", "main_adaptive", "main_async", "cli")
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
    "fd_jacobian": ("abs", 1e-7),       # the generic path's, at B = 1
    # K5ad: every dual operation rounds as torch's forward-mode formula, so
    # kernel and twin agree bit for bit (reported); the bar is the issue's
    "ad_jacobian": ("rel", 1e-13),
    "cost_expansion": ("rel", 0.0),     # and bit for bit
    # K7 is held bit for bit (check_kernels, bp_instances); this bar is the
    # floor of order_witness's, against its twin summed in torch's order
    "backward": ("rel", 1e-9),
}
# the kernels of a lane iteration: K5ad in K5's place (K5, central FD, is
# the generic solve's at deriv_mode "fd", held at B = 1 in main_async)
LANE_KERNELS = tuple(k for k in ops.KERNELS if k != "fd_jacobian")
REACHING_AGREE_TOL = 1e-3  # 3-iteration cost reduction, see main_path
# golden bars of tests/test_torch_golden.py (FD-noise spread, see there)
CTRL_ATOL, QPOS_ATOL, COST_ATOL = 2e-4, 5e-5, 4e-4


FAILED = []  # failed checks; main() raises on them before any result


def check(cond, msg):
    """Record a failed check and go on, so one run reports every phase."""
    if not cond:
        print(f"FAILED: {msg}", flush=True)
        FAILED.append(msg)


# this script's worker processes (start_worker), which launch their twins
# on the same card; card_alone stops them while kernels are timed
BESIDE = []
CARD_DRAIN_S = 0.5     # for what a stopped worker had queued on the card


@contextlib.contextmanager
def card_alone():
    """Stop this script's running worker processes (SIGSTOP) while the
    block times kernels, so that no other process launches on the card,
    and let them go on after (SIGCONT); yields whether any was stopped."""
    paused = [p for p in BESIDE if p.poll() is None]
    for p in paused:
        os.kill(p.pid, signal.SIGSTOP)
    try:
        if paused:
            time.sleep(CARD_DRAIN_S)
        yield bool(paused)
    finally:
        for p in paused:
            os.kill(p.pid, signal.SIGCONT)


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


def phase_ms(fn):
    """Device ms of a call warm from its path: one call, and where that
    took under LONG_CALL_MS the mean of 3 more."""
    ms = cuda_ms(fn, 1, 0)
    return ms if ms >= LONG_CALL_MS else cuda_ms(fn, 3, 0)


def err(a, b, kind):
    d = float((a - b).abs().max())
    if kind == "rel":
        return d, d / max(float(b.abs().max()), 1e-300)
    return d, d


# ---- analytic operation and byte counts for the bounds ---------------------


class Sizes:
    """Static sizes of a task for the bounds."""

    def __init__(self, task):
        m = task.model
        self.nq, self.nv, self.nu, self.nres = m.nq, m.nv, m.nu, task.nres
        self.nx = task.sv.nx                        # 2 x state-vector dofs
        self.ntgt = task.residual_targets.shape[0]
        joints = ops.body_joints(m)
        kinds = [m.jnt_type[j] for js in joints[1:] for j in js]
        self.n_scalar = sum(k in (HINGE, SLIDE) for k in kinds)
        self.n_welded = sum(not js for js in joints[1:])
        self.n_free = kinds.count(FREE)
        # (i, k < i) pairs of the mass matrix the CRBA fills: per body with
        # n dofs, its own earlier dofs and its ancestors' dofs
        anc = m.ancestor_mask.sum(1).tolist()
        self.m_pairs = 0
        for b, js in enumerate(joints):
            n = sum(6 if m.jnt_type[j] == FREE else 1 for j in js)
            self.m_pairs += n * (n - 1) // 2 + n * (int(anc[b]) - n)
        lim = 2 * len(limit_constants(m).joints)
        pairs = [(len(p.support), p.ncon)
                 for p in contact_constants(m).pairs]
        self.rows = lim + sum(4 * nc for _, nc in pairs)
        # sparse entries of the rows, and their squares (the Hessian)
        self.entries = lim + sum(4 * nc * w for w, nc in pairs)
        self.entries_sq = lim + sum(4 * nc * w * w for w, nc in pairs)
        self.lim_rows = lim
        self.contact_pairs = pairs
        self.pair_types = [p.types for p in contact_constants(m).pairs]
        self.fk_residual = task.residual_kind[0] in ops.FK_KINDS
        # a free rotation in the state: K4, K5 and K5ad take its rows as a
        # quaternion log, and K5ad steps the nominal once more per (slot,
        # lane)
        self.has_rot = any(m.jnt_dofadr[j] + 3 in task.sv.order
                           for j in range(m.njnt) if m.jnt_type[j] == FREE)


# double operations of the two geom poses and the narrow phase of a pair, by
# geom types (csrc/contact.cuh): ~300; plane-box's eight corners (~15 each),
# their depths and the 19 compare-exchanges of the sort (4 selects each)
# ~520; two sphere-box probes (~110 each) with a frame each ~440
NARROW_OPS = {(0, 6): 520, (3, 6): 440, (5, 6): 440, (6, 3): 440,
              (6, 5): 440}


def contact_ops(s):
    """Double operations of csrc/contact.cuh (K2b) per step: per pair
    NARROW_OPS (~300 but for the box pairs) for the two geom poses and the
    narrow phase, per slot ~46 (impedance, R, gate) plus 43 per support dof
    (point Jacobian 12, three frame rows 15, four rows' coefficients and
    velocity 16)."""
    return sum(NARROW_OPS.get(t, 300) + nc * (46 + 43 * w)
               for (w, nc), t in zip(s.contact_pairs, s.pair_types))


def newton_ops(s):
    """The NEWTON_ITERS iterations of csrc/constraint.cuh (constraint_ops'
    per-iteration terms)."""
    nv, rows, E, E2 = s.nv, s.rows, s.entries, s.entries_sq
    if rows == 0:
        return 0
    chol = nv ** 3 / 3 + 2 * nv ** 2
    per_it = (2 * E + rows + nv + 2 * nv ** 2 + 2 * E + 3 * E2 + nv ** 2
              + chol + 2 * E - rows + 2 * nv ** 2 + 6 * nv
              + (len(ALPHA_LADDER) + 1) * (5 * rows + 8) + 2 * nv)
    return NEWTON_ITERS * per_it


def implicit_primal_ops(s):
    """K2c's work on the values alone, once per (slot, lane): the residual
    F at the returned x (M e 2 nv^2, the rows' J x 2 E, gate and force
    4 R, J' f 2 E), the gated Hessian (3 E2 + nv^2) and its Cholesky
    (nv^3/3 + 2 nv^2)."""
    nv, rows, E, E2 = s.nv, s.rows, s.entries, s.entries_sq
    if rows == 0:
        return 0
    return (2 * nv ** 2 + 4 * E + 4 * rows + 3 * E2 + nv ** 2
            + nv ** 3 / 3 + 2 * nv ** 2)


def implicit_column_ops(s):
    """K2c per tangent column (csrc/constraint.cuh:implicit_tangent): the
    tangent of F (two operations per operation of F) and the two
    triangular solves for -dF (2 nv^2)."""
    nv, rows, E = s.nv, s.rows, s.entries
    if rows == 0:
        return 0
    return 2 * (2 * nv ** 2 + 4 * E + 4 * rows) + 2 * nv ** 2


def constraint_ops(s):
    """Double operations of csrc/constraint.cuh per step, counted from the
    source over the rows' E sparse entries (E2 the sum of their squares;
    a limit row has one entry): the limit rows ~30 each and the contact
    rows (contact_ops); a0 nv^3/3 + 2 nv^2; per Newton iteration y and the
    gate 2 E + R, e nv, M e 2 nv^2, gradient and H 2 E + 3 E2 + nv^2,
    Cholesky nv^3/3 + 2 nv^2, J dx 2 E - R, M dx 2 nv^2, three dot products
    6 nv, the merit at alpha = 0 and six step lengths 7 (5 R + 8), the
    update 2 nv; the force 4 R + 2 E."""
    nv, rows, E = s.nv, s.rows, s.entries
    if rows == 0:
        return 0
    chol = nv ** 3 / 3 + 2 * nv ** 2
    return (30 * s.lim_rows + contact_ops(s) + chol + newton_ops(s)
            + 4 * rows + 2 * E)


def step_ops(s):
    """Double operations of one step of csrc/step.cuh, counted per part:
    FK ~230 per hinge body (~60 for a welded one), body inertia ~190, RNE
    ~180; a free body ~1000 (pose and six cdof ~60, inertia, RNE over six
    dofs with the whole-twist rotations ~350, bias 66, its CRBA columns
    ~250, quaternion integration ~110); CRBA ~30 per dof plus 11 per pair
    of a dof and an earlier dof of its root path, forces ~10 per dof and
    actuator, Cholesky nv^3/3 and its solve 2 nv^2, Euler 4 nv; plus the
    constraint solve for a model with limits or contacts."""
    nv, nu = s.nv, s.nu
    return (630 * s.n_scalar + 430 * s.n_welded + 1000 * s.n_free
            + 11 * s.m_pairs + 10 * (nv + nu) + nv ** 3 / 3 + 2 * nv ** 2
            + 4 * nv + constraint_ops(s))


def cost_ops(s):
    """The residual and its weighted square; the push FK residual adds the
    end-effector site (~35) and three norms (~35)."""
    return 4 * s.nres + (70 if s.fk_residual else 0)


def bound(ops_count, bytes_count):
    t_ops = ops_count / F64_OPS_PER_S * 1e3
    t_bytes = bytes_count / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def rollout_bound(s, Hh, Bb):
    nu, ns = s.nu, s.nq + s.nv
    ops_ = Hh * Bb * (step_ops(s) + cost_ops(s))
    byt = F8 * Bb * (ns + Hh * nu + s.ntgt + (Hh + 1) * ns + Hh)
    return bound(ops_, byt)


def linesearch_bound(s, Hh, A, Bb):
    nu, nx, ns = s.nu, s.nx, s.nq + s.nv
    ops_ = Hh * A * Bb * (step_ops(s) + cost_ops(s) + 2 * nu * nx + 4 * nu
                          + nx)
    byt = F8 * (Bb * ((Hh + 1) * ns + Hh * nu * (2 + nx) + s.ntgt) + A
                + A * Bb * ((Hh + 1) * ns + Hh * nu + Hh))
    return bound(ops_, byt)


def ad_slot_ops(s):
    """Double operations that K5ad's function needs per (slot, lane): the
    primal step once (step_ops, its Newton iterations included) and K2c's
    values once (implicit_primal_ops), then for each of the 2n + nu
    columns of [A|B] the tangent of every operation of the step outside
    the Newton iterations, which run on the values alone (two per
    operation: a dual product adds three, a sum one), and K2c's column
    (implicit_column_ops).  The kernel does the primal part once per
    (slot, lane) in its primal pass."""
    nc = s.nx + s.nu
    # with a free rotation in the state, the nominal next state (the
    # quaternion rows' reference) is one more primal step
    return ((2 if s.has_rot else 1) * step_ops(s) + implicit_primal_ops(s)
            + nc * (2 * (step_ops(s) - newton_ops(s))
                    + implicit_column_ops(s)))


def ad_bound(s, K, Bb, live=None):
    """K5ad: ad_slot_ops per slot and lane (`live` of the K x Bb slots,
    where a plan leaves some dead), against reading each slot's state and
    control and writing its [A|B]."""
    nx, nc = s.nx, s.nx + s.nu
    n = K * Bb if live is None else live
    ops_ = n * ad_slot_ops(s)
    byt = F8 * (K + n * (s.nq + s.nv + s.nu) + K * Bb * nx * nc)
    return bound(ops_, byt)


def fd_bound(s, K, Bb):
    nx, nc = s.nx, s.nx + s.nu
    ops_ = K * Bb * (2 * nc * step_ops(s) + 2 * nc * nx)
    byt = F8 * K * (1 + Bb * (s.nq + s.nv + s.nu + nx * nc))
    return bound(ops_, byt)


def backward_bound(nx, nu, Hh, Bb, sweeps):
    nc = nx + nu
    per_step = (2 * nx * nx * nc + 2 * nx * nc + 2 * nx * (nc * nc - nx * nu)
                + nu ** 3 / 3 + 2 * nu * nu * (nx + 1) + 2 * nu * nu * (nx + 1)
                + 6 * nx * nu + 6 * nx * nx * nu + 2 * nx * nx + 4 * nu)
    ops_ = sweeps * Hh * Bb * per_step
    byt = F8 * (Hh * Bb * (nx * nx + nx * nu + nx + nx * nx + nu + nu * nu)
                + Hh * Bb * (nu + nu * nx) + 3 * Bb) + Bb
    return bound(ops_, byt)


def fk_ops(s):
    """The FK part of the step (csrc/step.cuh: fk_frames): ~230 per hinge
    or slide body, ~60 per welded one, ~100 per free one."""
    return 230 * s.n_scalar + 60 * s.n_welded + 100 * s.n_free


def cost_expansion_bound(s, Hh, Bb):
    """K6 (csrc/cost_expansion.cu): per (t, b) the residual, its closed-form
    Jacobian (a constant selection; for the FK residual the FK, two point
    Jacobians and the norms' derivatives, ~40 per state dof) and the
    Gauss-Newton products, l_z 2 nres nz and the (x, x) and (u, u) blocks
    3 nres (nx^2 + nu^2), against reading the state and control and
    writing l_x, l_xx, l_u, l_uu."""
    nz = s.nx + s.nu
    jac = fk_ops(s) + 40 * (s.nx // 2) if s.fk_residual else 0
    ops_ = Hh * Bb * (cost_ops(s) + jac + 2 * s.nres * nz
                      + 3 * s.nres * (s.nx * s.nx + s.nu * s.nu))
    byt = F8 * (Hh * Bb * (s.nq + s.nv + s.nu) + s.ntgt * Bb
                + Hh * Bb * (s.nx + s.nx * s.nx + s.nu + s.nu * s.nu))
    return bound(ops_, byt)


def apply_bound(s, Hh, NA, Bb):
    """K8: NA steps with their residual, noise and clip, and the blend of
    H nu controls, against reading U, U_n, the state, z, std, the targets
    and the flags and writing the shifted controls, the histories and the
    new state."""
    nu, ns = s.nu, s.nq + s.nv
    ops_ = Bb * (NA * (step_ops(s) + cost_ops(s) + 3 * nu) + 4 * Hh * nu)
    byt = F8 * (Bb * (ns + 2 * Hh * nu + 3 + NA * nu + s.ntgt) + nu
                + Bb * (ns + Hh * nu + NA * (ns + nu + 1) + 1))
    return bound(ops_, byt)


# ---- phases -----------------------------------------------------------------


def card_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def cuda_timed(fn):
    """(fn(), device ms of that one call by CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def lane_inputs(task, Hh, Bb, seed, at_limits=False):
    """Scenes, controls and gains.  `at_limits` starts half the lanes with
    every joint at one of its limits (+- 0.01 N), moving, under controls
    large enough to push into them, so limit rows are active."""
    qp, qv, tg = lanes.scenes(task, Bb, seed=seed)
    rng = np.random.default_rng(seed + 1)
    nv, nu, nx = task.model.nv, task.model.nu, task.sv.nx
    f64 = dict(dtype=torch.float64, device="cuda")
    scale = 0.3
    if at_limits:
        rngl = task.model.jnt_range.cpu().numpy()
        half = Bb // 2
        side = rng.integers(0, 2, (half, nv))
        qp[:half] = torch.as_tensor(
            np.where(side == 0, rngl[:, 0], rngl[:, 1])
            + 0.01 * rng.standard_normal((half, nv)), **f64)
        qv = torch.as_tensor(0.5 * rng.standard_normal((Bb, nv)), **f64)
        scale = 5.0
    U = torch.as_tensor(scale * rng.standard_normal((Hh, nu, Bb)), **f64)
    k = torch.as_tensor(0.1 * rng.standard_normal((Hh, nu, Bb)), **f64)
    K = torch.as_tensor(0.05 * rng.standard_normal((Hh, nu, nx, Bb)), **f64)
    return (qp.T.contiguous(), qv.T.contiguous(), tg.T.contiguous(), U, k, K)


_PUSH_STARTS = {}


def push_start(task, Hh=UH, Bb=UB):
    """A pushing task's main-path start (computed once per task and shape):
    Bb scenes from the task's generator (numpy seed 0) and the JAX app's
    initial controls, the setup servo behind the object (1000 steps), whose
    end is the start, then the init servo over Hh, both stepped by K3 at H
    = 1 with the FK products and bias force from fk_bias -> dict of the
    scenes' scene_qpos (nq, B) and scene_qvel (nv, B), the start qpos (nq,
    B), qvel (nv, B), targets (2, B), U (Hh, nu, B), the servo's wall
    seconds and its kernel launches."""
    key = (task.name, Hh, Bb)
    if key not in _PUSH_STARTS:
        qp, qv, tg = pushing.push_scenes(task, Bb, seed=0)
        tgl = tg.T.contiguous()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        qs, vs, U = pushing.init_controls(task, Hh, qp.T.contiguous(),
                                          qv.T.contiguous(), tgl)
        torch.cuda.synchronize()
        _PUSH_STARTS[key] = dict(
            scene_qpos=qp.T.contiguous(), scene_qvel=qv.T.contiguous(),
            qpos=qs, qvel=vs, targets=tgl, U=U.contiguous(),
            servo_s=time.perf_counter() - t0,
            launches={k: v for k, v in ops.LAUNCHES.items() if v})
    return _PUSH_STARTS[key]


def push_inputs(task, Hh, Bb, seed):
    """Check inputs for push_ncl: the first Bb servo-driven starts of the
    main path (push_start), where the pusher touches the goal and the goal
    rests on the table, and the init servo's first Hh controls.  The first
    quarter of the lanes adds N(0, 2) noise to the controls; the second
    starts with the shoulder (joint 2) 0.035 rad further down, which presses
    the pusher ~2 mm into the table (the servo holds it ~1 cm above); the
    second half runs the servo as it is.  Gains as lane_inputs."""
    st = push_start(task)
    qp0, qv0 = (st[k][:, :Bb].contiguous() for k in ("qpos", "qvel"))
    tgl = st["targets"][:, :Bb].contiguous()
    U = st["U"][:Hh, :, :Bb].contiguous()
    rng = np.random.default_rng(seed + 1)
    nu, nx = task.model.nu, task.sv.nx
    f64 = dict(dtype=torch.float64, device="cuda")
    noise = 2.0 * rng.standard_normal((Hh, nu, Bb))
    noise[..., Bb // 4:] = 0.0
    U = (U + torch.as_tensor(noise, **f64)).contiguous()
    qp0 = qp0.clone()
    qp0[1, Bb // 4:Bb // 2] += 0.035
    k = torch.as_tensor(0.1 * rng.standard_normal((Hh, nu, Bb)), **f64)
    K = torch.as_tensor(0.05 * rng.standard_normal((Hh, nu, nx, Bb)), **f64)
    return qp0, qv0, tgl, U, k, K


_BOX_STARTS = {}


def box_start(task, Hh, Bb):
    """A box task's main-path start (computed once per task and shape): Bb
    scenes of the JAX CLI's generic generator (numpy seed 0: the arm at
    qpos_start + 0.2 N(0, 1), the box at its default pose, the targets +
    0.1 N(0, 1)) and the end-effector servo over Hh from them (no setup
    servo), stepped by K3 at H = 1 with fk_bias -> the dict of push_start,
    the scenes being the start."""
    key = (task.name, Hh, Bb)
    if key not in _BOX_STARTS:
        qp, qv, tg = manipulation.box_scenes(task, Bb, seed=0)
        qp, qv, tgl = (x.T.contiguous() for x in (qp, qv, tg))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        qs, vs, U = task.init_controls_fn(task, Hh, qp, qv, tgl)
        torch.cuda.synchronize()
        _BOX_STARTS[key] = dict(
            scene_qpos=qp, scene_qvel=qv, qpos=qs, qvel=vs, targets=tgl,
            U=U.contiguous(), servo_s=time.perf_counter() - t0,
            launches={k: v for k, v in ops.LAUNCHES.items() if v})
    return _BOX_STARTS[key]


def start_of(task, Hh, Bb):
    """The main-path start of a task with initial controls."""
    if task.residual_kind[0] == "push":
        return push_start(task, Hh, Bb)
    return box_start(task, Hh, Bb)


def _pusher_geom(task):
    m = task.model
    return next(g for g in range(m.ngeom)
                if m.geom_bodyid[g] == m.site_bodyid[m.site_names.index("ee")]
                and m.geom_type[g] == 5)


def _fk(task, qp):
    """The FK products (Data) at qp (nq, L), zero velocity."""
    m = task.model
    z = torch.zeros((m.nv, qp.shape[1]), dtype=qp.dtype, device=qp.device)
    return forward_kinematics(m, Data(qpos=qp, qvel=z, ctrl=z[:m.nu]))


def _pusher_low_end(task, qp):
    """The pusher's lower axis end point (3, L) at qp (nq, L)."""
    m = task.model
    d = _fk(task, qp)
    g = _pusher_geom(task)
    xp, xm = geom_pose(m, d, g)
    hl = float(m.geom_size[g][1])
    e1, e2 = xp + xm[:, 2] * hl, xp - xm[:, 2] * hl
    return torch.where((e1[2] < e2[2])[None], e1, e2)


def pressed_arms(task, n, seed, depth=(-0.004, -0.001)):
    """n arm poses (7, n) whose pusher dips `depth` (m, the deepest slot of
    the table-pusher pair) into the table: drawn uniformly inside the arm's
    joint ranges from a numpy seed, kept where the depth falls in the band
    (the pusher rides ~0.15-0.3 m above the table on the tasks' own path,
    so the table-pusher rows need such poses)."""
    m = task.model
    rng = np.random.default_rng(seed)
    lo, hi = m.jnt_range[:7, 0].cpu().numpy(), m.jnt_range[:7, 1].cpu().numpy()
    f64 = dict(dtype=torch.float64, device="cuda")
    found = []
    for _ in range(20):
        cand = rng.uniform(lo, hi, (8192, 7))
        qp = task.qpos_start[:, None].repeat(1, 8192).clone()
        qp[:7] = torch.as_tensor(cand.T, **f64)
        slots = contact_slots(m, _fk(task, qp))[0]
        d = torch.stack(slots.dist).min(0).values
        ok = ((d > depth[0]) & (d < depth[1])).nonzero().flatten()
        found += [qp[:7, i] for i in ok.tolist()]
        if len(found) >= n:
            break
    check(len(found) >= n, f"{task.name}: only {len(found)} arm poses press "
                           "the pusher into the table")
    return torch.stack(found[:n], 1)


def box_inputs(task, Hh, Bb, seed):
    """Check inputs for a box task, in four quarters of the lanes: the
    scenes' start (box_scenes: the box resting flat on the table, its
    bottom corners tied in depth); the box tilted
    20 degrees about x (two corners below the table); the box around the
    pusher's lower end point, 4 mm inside its -x face (the sphere-box
    probe's inside branch); and the pusher pressed 1-4 mm into the table
    (`pressed_arms`) with the box resting 1 mm deep 8 mm from the end
    point (the probe outside the box, its radius 12 mm into it).  Controls
    are N(0, 2) in the first quarter, N(0, 0.5) elsewhere (no servo: the
    inputs need no kernel, so the twins' halves run beside the build);
    gains as lane_inputs."""
    m = task.model
    qa = m.jnt_qposadr[m.joint_names.index("goal")]
    gsize = m.geom_size[m.geom_bodyid.index(m.body_names.index("goal"))]
    hx, hz = float(gsize[0]), float(gsize[2])
    qp0, qv0, tgl = (x.T.contiguous() for x in manipulation.box_scenes(
        task, Bb, seed=seed))
    rng = np.random.default_rng(seed + 1)
    nu, nx = m.nu, task.sv.nx
    f64 = dict(dtype=torch.float64, device="cuda")
    q1, q2, q3 = Bb // 4, Bb // 2, 3 * Bb // 4
    scale = np.full(Bb, 0.5)
    scale[:q1] = 2.0
    U = torch.as_tensor(scale * rng.standard_normal((Hh, nu, Bb)),
                        **f64).contiguous()
    a = math.radians(20.0) / 2
    qp0[qa + 3:qa + 7, q1:q2] = torch.tensor(
        [math.cos(a), math.sin(a), 0.0, 0.0], **f64)[:, None]
    # the pusher's end point 4 mm inside the box's -x face, the box level
    e = _pusher_low_end(task, qp0[:, q2:q3])
    qp0[qa:qa + 3, q2:q3] = e + torch.tensor([hx - 0.004, 0.0, 0.0],
                                             **f64)[:, None]
    # the pusher pressed into the table, the box beside it, 1 mm deep
    qp0[:7, q3:] = pressed_arms(task, Bb - q3, seed)
    e = _pusher_low_end(task, qp0[:, q3:])
    qp0[qa, q3:] = e[0] + hx + 0.008
    qp0[qa + 1, q3:] = e[1]
    qp0[qa + 2, q3:] = hz - 0.001
    k = torch.as_tensor(0.1 * rng.standard_normal((Hh, nu, Bb)), **f64)
    K = torch.as_tensor(0.05 * rng.standard_normal((Hh, nu, nx, Bb)), **f64)
    return (qp0.contiguous(), qv0.contiguous(), tgl.contiguous(), U, k, K)


def clutter_inputs(task, Hh, Bb, seed):
    """Check inputs for a clutter task (push_lcl, push_ccl), in four
    quarters of the lanes, every object 0.5 mm into the table but the
    first quarter's: the scenes of the task's generator (the objects 2 mm
    above the table, settling onto it), under N(0, 2) controls; the goal
    and obstacles 1 and 2 in a triangle pressed 0.5 mm into each other,
    obstacle 3 pressed into the goal; obstacles 1-3 in such a triangle
    beside the goal; and the pusher pressed 1-4 mm into the table
    (`pressed_arms`) with one object in turn pressed 2 mm into its lower end
    point.  Every one of the 15 pairs touches.  Controls N(0, 0.5) beyond
    the first quarter (no servo: the inputs need no kernel, so the twins'
    halves run beside the build); gains as lane_inputs."""
    m = task.model
    bodies = ("goal", "obstacle_1", "obstacle_2", "obstacle_3")
    qa = [m.jnt_qposadr[m.joint_names.index(b)] for b in bodies]
    qp0, qv0, tgl = (x.T.contiguous() for x in pushing.push_scenes(
        task, Bb, seed=seed))
    rng = np.random.default_rng(seed + 1)
    nu, nx = m.nu, task.sv.nx
    f64 = dict(dtype=torch.float64, device="cuda")
    q1, q2, q3 = Bb // 4, Bb // 2, 3 * Bb // 4
    scale = np.full(Bb, 0.5)
    scale[:q1] = 2.0
    U = torch.as_tensor(scale * rng.standard_normal((Hh, nu, Bb)),
                        **f64).contiguous()
    z = pushing.OBJECT_Z - 0.0025
    d = 2 * pushing.OBJECT_R - 0.0005
    tri = [(0.5, 0.0), (0.5 + d, 0.0), (0.5 + d / 2, d * math.sqrt(0.75))]
    for a, (x, y) in zip(qa[:3], tri):
        qp0[a, q1:q2], qp0[a + 1, q1:q2] = x, y
    qp0[qa[3], q1:q2], qp0[qa[3] + 1, q1:q2] = 0.5 - d, 0.0
    qp0[qa[0], q2:q3], qp0[qa[0] + 1, q2:q3] = 0.35, -0.25
    for a, (x, y) in zip(qa[1:], tri):
        qp0[a, q2:q3], qp0[a + 1, q2:q3] = x + 0.1, y - 0.3
    qp0[:7, q3:] = pressed_arms(task, Bb - q3, seed)
    e = _pusher_low_end(task, qp0[:, q3:])
    r = float(m.geom_size[_pusher_geom(task)][0]) + pushing.OBJECT_R - 0.002
    for i, lane in enumerate(range(q3, Bb)):
        a = qa[i % 4]
        qp0[a, lane] = e[0, i] + r
        qp0[a + 1, lane] = e[1, i]
    for a in qa:
        qp0[a + 2, q1:] = z
    k = torch.as_tensor(0.1 * rng.standard_normal((Hh, nu, Bb)), **f64)
    K = torch.as_tensor(0.05 * rng.standard_normal((Hh, nu, nx, Bb)), **f64)
    return qp0, qv0, tgl, U, k, K


def walker_inputs(task, Hh, Bb, seed):
    """Check inputs for the walker: a quarter of the lanes with a shin
    pressed ~1 cm into the torso (legs folded far past their +-1 degree
    limits: a capsule-capsule pair, tests/test_torch_walker.py), the rest
    with the torso 0-4 cm into the floor, tilted, and random leg angles
    (plane-capsule pairs); controls U(-1, 1), gains as lane_inputs."""
    rng = np.random.default_rng(seed)
    m = task.model
    nu, nx = m.nu, task.sv.nx
    f64 = dict(dtype=torch.float64, device="cuda")
    qp = np.tile(task.qpos_start.cpu().numpy()[:, None], (1, Bb))
    n4 = Bb // 4
    qp[0, :n4] = 0.5
    qp[3:, :n4] = np.array([0.78, 2.86, 2.57, -2.66, -2.88, 2.59])[:, None]
    qp[0, n4:] = rng.uniform(-0.04, 0.0, Bb - n4)
    qp[2, n4:] = rng.uniform(-0.3, 0.3, Bb - n4)
    qp[3:, n4:] = rng.uniform(-0.5, 0.5, (6, Bb - n4))
    qv = 0.3 * rng.standard_normal((m.nv, Bb))
    U = rng.uniform(-1.0, 1.0, (Hh, nu, Bb))
    k = 0.1 * rng.standard_normal((Hh, nu, Bb))
    K = 0.05 * rng.standard_normal((Hh, nu, nx, Bb))
    tg = task.residual_targets[:, None].expand(-1, Bb)
    return tuple(torch.as_tensor(x, **f64).contiguous()
                 for x in (qp, qv, tg, U, k, K))


def pentabot_inputs(task, Hh, Bb, seed):
    """Check inputs for pentabot: every joint folded at random (U(-3, 3)
    rad), so that its non-adjacent links touch (its six capsule-capsule
    pairs, tests/test_torch_pentabot.py), qvel 0.3 N(0, 1), controls
    0.3 N(0, 1), gains as lane_inputs."""
    rng = np.random.default_rng(seed)
    m = task.model
    nu, nx = m.nu, task.sv.nx
    f64 = dict(dtype=torch.float64, device="cuda")
    qp = rng.uniform(-3.0, 3.0, (m.nq, Bb))
    qv = 0.3 * rng.standard_normal((m.nv, Bb))
    U = 0.3 * rng.standard_normal((Hh, nu, Bb))
    k = 0.1 * rng.standard_normal((Hh, nu, Bb))
    K = 0.05 * rng.standard_normal((Hh, nu, nx, Bb))
    tg = task.residual_targets[:, None].expand(-1, Bb)
    return tuple(torch.as_tensor(x, **f64).contiguous()
                 for x in (qp, qv, tg, U, k, K))


def check_apply(task, qp0, qv0, tg, U, seed, num_apply=1):
    """K8 against its twin (mpc/sync.py:apply_controls) on the same inputs:
    blended controls from U and a second control sequence, half of the
    lanes accepted, standard-normal noise."""
    Hh, Bb = U.shape[0], U.shape[-1]
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device="cuda")
    Un = torch.as_tensor(rng.uniform(-1.0, 1.0, U.shape), **f64)
    z = torch.as_tensor(rng.standard_normal((num_apply, task.model.nu, Bb)),
                        **f64)
    accept = torch.arange(Bb, device="cuda") % 2 == 0
    best = torch.as_tensor(rng.random(Bb), **f64)
    old = best + 1.0
    std = mpc_sync.noise_std(task, 5.0)
    args = (task, qp0, qv0, U, Un, accept, best, old, z, std, tg)
    ka = ops.mpc_apply(*args)
    pa, plain_ms = cuda_timed(lambda: ops.mpc_apply(*args, plain=True))
    e = max((err(a, b, "rel") for a, b in zip(ka, pa)), key=lambda x: x[1])
    same = all(bool(torch.equal(a, b)) for a, b in zip(ka, pa))
    row = dict(err=e, bitwise=same, plain_ms=plain_ms,
               ms=cuda_ms(lambda: ops.mpc_apply(*args), 5),
               bound=apply_bound(Sizes(task), Hh, num_apply, Bb),
               tol="rel 1e-12")
    print(f"  {task.name} mpc_apply (H={Hh}, B={Bb}, num_apply "
          f"{num_apply}): kernel vs plain max abs err {e[0]:.3e} (compared "
          f"{e[1]:.3e}), bitwise equal {same}, {row['ms']:.4f} ms (plain "
          f"{plain_ms:.4f} ms)", flush=True)
    check(math.isfinite(e[1]) and e[1] <= 1e-12,
          f"{task.name} mpc_apply: kernel vs plain error {e[1]:.3e}")
    return row


def fk_bias_ops(s):
    """The FK and RNE part of step_ops (what fk_bias runs): 630 per hinge
    or slide body, 430 per welded one, 900 per free one."""
    return 630 * s.n_scalar + 430 * s.n_welded + 900 * s.n_free


def check_fk_bias(task, qpos, qvel):
    """The servo's fk_bias kernel against its twin (forward_kinematics +
    bias_force) at the states qpos (H, nq, B), qvel (H, nv, B), one lane
    per (time, lane) pair."""
    m = task.model
    q = qpos.transpose(0, 1).reshape(m.nq, -1).contiguous()
    v = qvel.transpose(0, 1).reshape(m.nv, -1).contiguous()
    n = q.shape[1]
    kr = ops.fk_bias(task, q, v)
    pr, plain_ms = cuda_timed(lambda: ops.fk_bias(task, q, v, plain=True))
    e = max((err(a, b, "rel") for a, b in zip(kr, pr)), key=lambda x: x[1])
    same = all(bool(torch.equal(a, b)) for a, b in zip(kr, pr))
    byt = F8 * n * (m.nq + m.nv + 7 * m.nbody + 7 * m.nv)
    out = dict(err=e, bitwise=same, lanes=n, plain_ms=plain_ms,
               ms=cuda_ms(lambda: ops.fk_bias(task, q, v), 5),
               bound=bound(n * fk_bias_ops(Sizes(task)), byt),
               tol="rel 1e-12")
    print(f"  {task.name} fk_bias ({n} lanes): kernel vs plain max abs err "
          f"{e[0]:.3e} (compared {e[1]:.3e}), bitwise equal {same}, "
          f"{out['ms']:.4f} ms (plain {plain_ms:.4f} ms)", flush=True)
    check(math.isfinite(e[1]) and e[1] <= 1e-12,
          f"{task.name} fk_bias: kernel vs plain error {e[1]:.3e}")
    return out


def check_servo(task, st, horizon, steps=SERVO_CHECK):
    """A main path's servo against its plain twin at the shape it runs (its
    lanes): fk_bias at the scenes' start and, for push_ncl, at the start
    the setup servo reached, then the first SERVO_CHECK steps of push_ncl's
    setup servo (from the scenes) and of the init servo over `horizon`
    (from the solve's start; `steps` of each, SERVO_CHECK unless given),
    the kernel servo against the plain servo
    (`servo_along_path(plain=True)`: the twins of fk_bias and of the K3
    step); the kernel init servo must give the main path's own first
    controls.  The box tasks have no setup servo: their start is the
    scenes'."""
    tgl, n = st["targets"], steps
    setup = task.residual_kind[0] == "push"
    starts = (("scene_qpos", "scene_qvel"),) + (
        (("qpos", "qvel"),) if setup else ())
    fk = [check_fk_bias(task, st[q][None], st[v][None]) for q, v in starts]
    out = dict(fk_bias=fk, steps=n)
    cases = ((("setup", pushing.setup_path, pushing.SETUP_STEPS,
               st["scene_qpos"], st["scene_qvel"]),) if setup else ()) + (
        ("init", pushing.ee_waypoint_path, horizon, st["qpos"], st["qvel"]),)
    for name, make_path, horizon, q0, v0 in cases:
        path, angle = make_path(task, horizon, q0, tgl)
        ks = pushing.servo_along_path(task, path[:n], angle, q0, v0, tgl)
        t0 = time.perf_counter()
        ps = pushing.servo_along_path(task, path[:n], angle, q0, v0, tgl,
                                      plain=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        e = max((err(a, b, "rel") for a, b in zip(ks, ps)),
                key=lambda x: x[1])
        same = all(bool(torch.equal(a, b)) for a, b in zip(ks, ps))
        out[name] = dict(err=e, bitwise=same, plain_s=plain_s)
        print(f"  {task.name} {name} servo, {n} steps at {q0.shape[1]} "
              f"lanes: kernel vs plain servo (U, end qpos, qvel) max abs err "
              f"{e[0]:.3e} (compared {e[1]:.3e}), bitwise equal {same}, "
              f"plain {plain_s:.2f} s", flush=True)
        check(math.isfinite(e[1]) and e[1] <= 1e-10,
              f"{task.name} {name} servo: kernel vs plain error {e[1]:.3e}")
        if name == "init":
            e = err(ks[0], st["U"][:n], "rel")
            out["main_U_err"] = e
            print(f"  {task.name} init servo: its first {n} controls vs the "
                  f"main path's, max abs err {e[0]:.3e}", flush=True)
            check(e[1] <= 1e-10, f"{task.name}: the init servo's controls "
                                 f"differ from the main path's by {e[1]:.3e}")
    return out


def order_witness(A, Bm, l, lam, cfg, kb):
    """K7's result kb against its twin in the kernel's summation order on
    the CPU and in torch's order (`sum_contract`) on the card and on the
    CPU, over the lanes whose λ and λ-exit all agree: (max abs err,
    compared err) of k and K per pair, and the bar below.  The other order
    as far from the kernel as from itself across devices says that a gap
    is rounding order through the problem's conditioning, not a fault of
    the kernel; it is also how a K7 that sums in another order is held.
    Apart, the kernel-order twin on the CPU with a correctly rounded sqrt
    (exact_cpu_sqrt): `exact_sqrt_bitwise` says whether it lands on the
    kernel bit for bit, held as check_kernels holds the twin on the card
    (λ and λ-exit at every lane, k, K and dJ where no λ-exit), so that the
    CPU's one gap, `kernel_vs_kernel_order_cpu`, is torch's CPU sqrt
    (`cpu_sqrt_off_share`, this host's)."""
    cpu = [x.cpu() for x in (A, Bm, *l, lam)]
    with exact_cpu_sqrt():
        exact = [x.to(kb[0].device)
                 for x in ilqr.backward_pass_lambda_loop(*cpu, cfg)]
    runs = {
        "kernel_order_cpu": ilqr.backward_pass_lambda_loop(*cpu, cfg),
        "sum_order_cuda": ilqr.backward_pass_lambda_loop(
            A, Bm, *l, lam, cfg, contract=ilqr.sum_contract),
        "sum_order_cpu": ilqr.backward_pass_lambda_loop(
            *cpu, cfg, contract=ilqr.sum_contract),
    }
    runs = {k: [x.to(kb[0].device) for x in v] for k, v in runs.items()}
    live = ~kb[4]
    for r in runs.values():
        live &= (r[3] == kb[3]) & (r[4] == kb[4])

    def gap(x, y):
        return max((err(a[..., live], b[..., live], "rel")
                    for a, b in zip(x[:2], y[:2])),
                   key=lambda z: z[1])
    out = {f"kernel_vs_{k}": gap(kb, v) for k, v in runs.items()}
    run = ~kb[4]
    out["exact_sqrt_bitwise"] = (
        bool(torch.equal(exact[3], kb[3]))
        and bool(torch.equal(exact[4], kb[4]))
        and all(same_values(a[..., run], b[..., run])
                for a, b in zip(kb[:3], exact[:3])))
    out["cpu_sqrt_off_share"] = cpu_sqrt_off_share()
    out["sum_order_cuda_vs_cpu"] = gap(runs["sum_order_cuda"],
                                       runs["sum_order_cpu"])
    out["lanes"] = int(live.sum())
    # K7 must sit inside the spread that rounding order alone makes: as
    # close to the other order's twin as that twin is to itself across
    # devices (ten times, and at least TOL's bar); a fault lands far outside
    out["bar"] = max(TOL["backward"][1], 10 * out["sum_order_cuda_vs_cpu"][1])
    return out


# bp_instances: K7 at every built instance, at these lanes (one, and one
# past a block of the warp-per-lane instances' 4) over BP_CHECK_H steps
BP_CHECK_B = (1, 5)
BP_CHECK_H = 12


def bp_instances(logs):
    """K7 at every backward-pass instance built: its launch geometry
    (ops.backward_geometry), registers, stack and local memory
    (sass_counts.py --resources), ptxas's spill stores and its nvcc
    seconds, and the kernel against its twin on `backward_inputs` with λ
    retries and λ-exits at BP_CHECK_B lanes: k, K, dJ, λ and λ-exit bit for
    bit (NaN gains where the twin's are NaN)."""
    cfg = ILQRConfig()
    table = nvcc_table(logs)
    out = {}
    for inst in build.instance_names()[1]:
        nx, nu = map(int, re.match(r"nx(\d+)_nu(\d+)", inst).groups())
        g = ops.backward_geometry(nx, nu)
        res = sass_counts.resources_of(build.library_path("backward", inst))
        ptx = table.get(f"backward-{inst}", {})
        row = out[inst] = dict(
            geometry=g._asdict(), resources=res, nvcc_s=ptx.get("s"),
            spill_stores=ptx.get("spill_stores"), held={})
        for Bb in BP_CHECK_B:
            inputs = backward_inputs(nx, nu, BP_CHECK_H, Bb, seed=nx + Bb,
                                     device="cuda", retries=True)
            info = {}
            kb = ops.backward(*inputs, cfg, info=info)
            pb = ops.backward(*inputs, cfg, plain=True)
            same = {name: same_values(a, b) for name, a, b in zip(
                ("k", "K", "dJ", "lambda", "lambda_exit"), kb, pb)}
            row["held"][Bb] = dict(same, sweeps=bp_sweeps(info),
                                   exits=int(pb[4].sum()))
            check(all(same.values()), f"backward {inst} at B={Bb}: kernel "
                  f"vs plain not bit for bit: {same}")
        print(f"  backward {inst}: {json.dumps(row)}", flush=True)
    return out


# step_instances: K4 and K5ad at every model instance, at these lanes (one,
# and five: 30 (alpha, scene) lanes, and in blocks of four lanes the last
# block half full) over STEP_CHECK_H steps
STEP_CHECK_B = (1, 5)
STEP_CHECK_H = 3
STEP_TASKS = ("acrobot", "pentabot", "reaching", "pushing_no_clutter",
              "walker_run", "box_sweep", "threeD_push", "pushing_low_clutter")


def pressed_push_inputs(task, Hh, Bb, seed):
    """Check inputs for push_ncl without its servo: the task's scenes with
    the goal 0.5 mm into the table, and the second half of the lanes with
    the pusher pressed 1-4 mm into the table (`pressed_arms`), under
    N(0, 0.5) controls; gains as lane_inputs."""
    m = task.model
    qa = m.jnt_qposadr[m.joint_names.index("goal")]
    qp0, qv0, tgl = (x.T.contiguous() for x in pushing.push_scenes(
        task, Bb, seed=seed))
    rng = np.random.default_rng(seed + 1)
    nu, nx = m.nu, task.sv.nx
    f64 = dict(dtype=torch.float64, device="cuda")
    half = Bb // 2
    if Bb - half:
        qp0[:7, half:] = pressed_arms(task, Bb - half, seed)
    qp0[qa + 2, :] = pushing.OBJECT_Z - 0.0025
    U = torch.as_tensor(0.5 * rng.standard_normal((Hh, nu, Bb)),
                        **f64).contiguous()
    k = torch.as_tensor(0.1 * rng.standard_normal((Hh, nu, Bb)), **f64)
    K = torch.as_tensor(0.05 * rng.standard_normal((Hh, nu, nx, Bb)), **f64)
    return qp0, qv0, tgl, U, k, K


def step_inputs(task, Hh, Bb, seed):
    """Each model's check inputs, with its rows active (limits or
    contacts)."""
    if task.name == "pentabot":
        return pentabot_inputs(task, Hh, Bb, seed)
    if task.name.startswith("walker"):
        return walker_inputs(task, Hh, Bb, seed)
    if task.residual_kind[0] in ("sweep", "tilt_push"):
        return box_inputs(task, Hh, Bb, seed)
    if task.residual_kind[0] == "push":
        return (clutter_inputs if task.residual_kind[1] else
                pressed_push_inputs)(task, Hh, Bb, seed)
    return lane_inputs(task, Hh, Bb, seed, at_limits=task.name == "reaching")


def step_twins():
    """The twins of step_instances (`--plain-check-worker step_instances`,
    beside the build: they launch no kernel) -> {(task, B): (inputs, the
    plain rollout's qpos and qvel, K4's twin, K5ad's twin at every step
    and in its other slot modes, the plain rollout's costs, K5's twin at
    every step and in its other slot modes)}."""
    cfg = ILQRConfig()
    alphas = ilqr.default_alphas(cfg.num_parallel_rollouts, device="cuda")
    out = {}
    for name in STEP_TASKS:
        task = make_task(name, device="cuda")
        for Bb in STEP_CHECK_B:
            inputs = step_inputs(task, STEP_CHECK_H, Bb, seed=11 + Bb)
            qp0, qv0, tg, U, k, K = inputs
            qpos, qvel, costs = ops.rollout(task, qp0, qv0, U, tg,
                                            plain=True)
            times = torch.arange(STEP_CHECK_H, device="cuda")
            out[(name, Bb)] = (
                inputs, qpos, qvel,
                ops.linesearch(task, qpos, qvel, U, k, K, alphas, tg,
                               plain=True),
                ops.ad_jacobian(task, qpos, qvel, U, times, plain=True),
                ad_modes(task, qpos, qvel, U, plain=True), costs,
                ops.fd_jacobian(task, qpos, qvel, U, times, cfg.fd_eps,
                                plain=True),
                fd_modes(task, qpos, qvel, U, plain=True))
    return out


def plans(g, n):
    """A kernel's plan `g` and, where it runs a warp per lane, the same in
    blocks of `n` lanes (the last block part full at the checks' sizes)."""
    return [g, g._replace(lanes=n, threads=32 * n,
                          smem_bytes=g.smem_bytes // g.lanes * n)] \
        if g.warp else [g]


def step_instances(logs, plain=None):
    """K3, K4, K5 and K5ad at every model instance: their launch plans
    (K4's geometry at six alphas and the main paths' 128 scenes, lanes a
    block, shared memory, resident lanes and waves; K3's at one alpha, at
    128 scenes and one; K5's at the async planner's 50 slots of one scene
    and at 100 slots of 64 scenes; K5ad's primal entries per (slot, lane)
    and slots a chunk), registers, stack and local memory (sass_counts.py
    --resources), ptxas's spill stores and nvcc seconds; and all four
    against their twins (step_twins, run beside the build, or here without
    `plain`) on step_inputs at STEP_CHECK_B lanes over STEP_CHECK_H steps,
    bit for bit: K3 and K4 in their own geometry and, with a warp per lane,
    in blocks of two (K3) or four (K4) lanes; K5 at shared slot times,
    per-lane times with live counts and into the iterative_error cache, in
    its plan and, a warp per item, in blocks of three items; K5ad in the
    same three modes, with all slots a chunk and one (one pass where the
    model has no primal entries)."""
    cfg = ILQRConfig()
    alphas = ilqr.default_alphas(cfg.num_parallel_rollouts, device="cuda")
    nA = alphas.shape[0]
    table = nvcc_table(logs)
    plain = plain or step_twins()
    out = {}
    for name in STEP_TASKS:
        task = make_task(name, device="cuda")
        tag = ops.kernel_args(task, task.model.device).tag
        stag = build.step_shared().get(tag, tag)
        topo = build.instance_tables()[tag]
        g = ops.linesearch_geometry(topo, nA, 128)
        entries = ops.ad_primal_entries(topo)
        stopo = build.instance_tables()[stag]
        row = out[name] = dict(
            instance=tag, linesearch_geometry=dict(
                g._asdict(), lane_bytes=g.smem_bytes // g.lanes if g.warp
                else 0, resident_lanes=ops.NUM_SMS * g.blocks_per_sm
                * g.lanes, waves=g.waves(nA, 128)),
            rollout_geometry={f"B={b_}": ops.linesearch_geometry(
                topo, 1, b_)._asdict() for b_ in (128, 1)},
            fd_geometry={f"K={k_} B={b_}": dict(
                ops.fd_geometry(stopo, k_, b_)._asdict(),
                items=k_ * (2 * stopo.NDOF + stopo.NU) * b_,
                item_bytes=8 * ops.fd_lane_doubles(stopo))
                for k_, b_ in ((50, 1), (100, 64))},
            ad_primal_entries=entries, ad_chunk_main=ops.ad_chunk(
                entries, 1000, 128), held={})
        for src, inst in (("linesearch", tag), ("ad_jacobian", stag),
                          ("fd_jacobian", stag), ("rollout", tag)):
            ptx = table.get(f"{src}-{inst}", {})
            row[src] = dict(
                resources=sass_counts.resources_of(
                    build.library_path(src, inst)),
                nvcc_s=ptx.get("s"), registers=ptx.get("registers"),
                stack=ptx.get("stack"), spill_stores=ptx.get("spill_stores"))
        for Bb in STEP_CHECK_B:
            ((qp0, qv0, tg, U, k, K), qpos, qvel, pl, pj, pmodes, pcost,
             pfd, pfmodes) = plain[(name, Bb)]
            ro = {f"lanes_{geo.lanes}": all(same_values(a, b) for a, b in zip(
                ops.rollout(task, qp0, qv0, U, tg, geometry=geo),
                (qpos, qvel, pcost)))
                for geo in plans(ops.linesearch_geometry(topo, 1, Bb), 2)}
            times = torch.arange(STEP_CHECK_H, device="cuda")
            fd = {}
            for geo in plans(ops.fd_geometry(stopo, STEP_CHECK_H, Bb), 3):
                kf = ops.fd_jacobian(task, qpos, qvel, U, times,
                                     cfg.fd_eps, geometry=geo)
                km = fd_modes(task, qpos, qvel, U, geometry=geo)
                fd[f"lanes_{geo.lanes}"] = dict(
                    shared=same_values(kf, pfd), per_lane=same_values(
                        km[0], pfmodes[0]),
                    ie_cache=same_values(km[1], pfmodes[1]))
            ls = {f"lanes_{geo.lanes}": all(same_values(a, b) for a, b in zip(
                ops.linesearch(task, qpos, qvel, U, k, K, alphas, tg,
                               geometry=geo), pl))
                for geo in plans(ops.linesearch_geometry(topo, nA, Bb), 4)}
            ad = {}
            cap = ops.AD_PRIMAL_CAP_BYTES
            try:
                for label, c in (("chunk_all", cap), ("chunk_1", 1)):
                    ops.AD_PRIMAL_CAP_BYTES = c
                    kj = ops.ad_jacobian(task, qpos, qvel, U, times)
                    modes = ad_modes_check(task, qpos, qvel, U, plain=pmodes)
                    ad[label] = dict(shared=same_values(kj, pj),
                                     **{m: v[0] for m, v in modes.items()})
            finally:
                ops.AD_PRIMAL_CAP_BYTES = cap
            active = (contact_counts(task, qpos)["lane_steps_by_pair"]
                      if task.model.contact_pairs else None)
            row["held"][Bb] = dict(rollout=ro, linesearch=ls,
                                   fd_jacobian=fd, ad_jacobian=ad,
                                   contact_lane_steps=active)
            check(all(ro.values()), f"rollout {name} at B={Bb}: kernel "
                  f"vs plain not bit for bit: {ro}")
            check(all(all(v.values()) for v in fd.values()),
                  f"fd_jacobian {name} at B={Bb}: kernel vs plain not bit "
                  f"for bit: {fd}")
            check(all(ls.values()), f"linesearch {name} at B={Bb}: kernel "
                  f"vs plain not bit for bit: {ls}")
            check(all(all(v.values()) for v in ad.values()),
                  f"ad_jacobian {name} at B={Bb}: kernel vs plain not bit "
                  f"for bit: {ad}")
        print(f"  step {name}: {json.dumps(row)}", flush=True)
    return out


def check_orders(name, wit):
    print(f"  {name} backward, summation orders: {json.dumps(wit)}",
          flush=True)
    check(wit["kernel_vs_sum_order_cpu"][1] <= wit["bar"],
          f"{name} backward vs the sum-order twin: "
          f"{wit['kernel_vs_sum_order_cpu'][1]:.3e} > {wit['bar']:.3e}")


def contact_counts(task, qpos):
    """Per contact pair, the lane-steps and lanes of qpos (H, nq, B) with a
    slot within its margin."""
    act = contacts_active(task.model, qpos.transpose(0, 1))  # (np, H, B)
    return dict(lane_steps_by_pair=act.sum((1, 2)).tolist(),
                lanes_by_pair=act.any(1).sum(1).tolist(), of=act[0].numel())


def note(task, name, rows):
    print(f"  {task.name} {name}: kernel vs plain max abs err "
          f"{rows[name]['err'][0]:.3e} (compared {rows[name]['err'][1]:.3e})",
          flush=True)


def lane_slots(Hh, Bb, seed, K=8):
    """Per-lane slot times (K, Bb), sorted, and live counts in 1..K of a
    check's per-lane slot modes, from a torch seed."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    slot_t = torch.sort(torch.randint(0, Hh, (K, Bb), generator=g),
                        dim=0).values.to("cuda").contiguous()
    counts = torch.randint(1, K + 1, (Bb,), generator=g,
                           dtype=torch.int32).to("cuda")
    return slot_t, counts


def ad_modes(task, q0, v0, U0, plain=False, seed=5):
    """K5ad, or its twin, in its other slot modes: at per-lane slot times
    with live counts (lane_slots; dead slots write zeros) and scattered into
    an iterative_error cache -> (per-lane output, cache)."""
    Hh, Bb = U0.shape[0], U0.shape[-1]
    slot_t, counts = lane_slots(Hh, Bb, seed)
    nx, nc = task.sv.nx, task.sv.nx + task.model.nu
    cache = torch.zeros((Hh, nx, nc, Bb), dtype=torch.float64, device="cuda")
    ops.ad_jacobian(task, q0, v0, U0, slot_t, counts=counts, cache=cache,
                    plain=plain)
    return (ops.ad_jacobian(task, q0, v0, U0, slot_t, counts=counts,
                            plain=plain), cache)


def fd_modes(task, q0, v0, U0, plain=False, seed=5, geometry=None):
    """K5, or its twin, in its other slot modes, as ad_modes -> (per-lane
    output, cache)."""
    Hh, Bb = U0.shape[0], U0.shape[-1]
    slot_t, counts = lane_slots(Hh, Bb, seed)
    nx, nc = task.sv.nx, task.sv.nx + task.model.nu
    eps = ILQRConfig().fd_eps
    cache = torch.zeros((Hh, nx, nc, Bb), dtype=torch.float64, device="cuda")
    ops.fd_jacobian(task, q0, v0, U0, slot_t, eps, counts=counts,
                    cache=cache, plain=plain, geometry=geometry)
    return (ops.fd_jacobian(task, q0, v0, U0, slot_t, eps, counts=counts,
                            plain=plain, geometry=geometry), cache)


def ad_modes_check(task, q0, v0, U0, plain=None):
    """K5ad in its other slot modes (ad_modes) against its twin's outputs
    `plain`, or its twin run here -> {mode: (bit for bit, max abs err)}."""
    kj, kc = ad_modes(task, q0, v0, U0)
    pj, pc = plain or ad_modes(task, q0, v0, U0, plain=True)
    return {"per_lane": outputs_gap(kj, pj), "ie_cache": outputs_gap(kc, pc)}


def fd_twins(task, q0, v0, U0, times):
    """K5's twin at shared slot times (timed) and at per-lane slots with
    live counts (lane_slots) -> (shared, ms, per-lane)."""
    pj, plain_ms = cuda_timed(lambda: ops.fd_jacobian(
        task, q0, v0, U0, times, 1e-6, plain=True))
    slot_t, counts = lane_slots(U0.shape[0], U0.shape[-1], seed=6)
    return pj, plain_ms, ops.fd_jacobian(task, q0, v0, U0, slot_t, 1e-6,
                                         counts=counts, plain=True)


def check_kernels(task, Hh, Bb, time_them, at_limits=False, inputs=None,
                  pair_types=False, plain=None, exact=False):
    """Each kernel against its plain twin on the same inputs (`inputs`, or
    lane_inputs): K5ad at every step (SI_1) and in its per-lane and cache
    modes (`ad_modes_check`).  Every contact pair must be active in the
    plain rollout, or with `pair_types` every type of pair (the walker's
    capsule pairs touch only far past their joint limits).  `plain`, when
    given, holds the twins' outputs and ms of K3, K4, K5ad, K6 and K7
    (twin_outputs, run beside the build); K6 and K7 must equal their twins
    bit for bit (K7 in k, K and dJ of the lanes that did not λ-exit, and
    in λ and λ-exit), and with `exact` every kernel."""
    s = Sizes(task)
    gated = at_limits or bool(task.model.contact_pairs)
    qp0, qv0, tg, U, k, K = inputs or lane_inputs(task, Hh, Bb, seed=3,
                                                  at_limits=at_limits)
    cfg = ILQRConfig()
    alphas = ilqr.default_alphas(cfg.num_parallel_rollouts, device="cuda")
    plan = lanes.si_plan(si1(task), Hh)
    rows = {}
    check(plain is None or gated, "twin_outputs takes the Jacobians along "
                                  "the rollout: a task with constraint rows")

    def twin(name, fn):
        return plain[name] if plain else cuda_timed(fn)

    # K3 rollout
    kr = ops.rollout(task, qp0, qv0, U, tg)
    pr, plain_ms = twin("rollout", lambda: ops.rollout(task, qp0, qv0, U, tg,
                                                       plain=True))
    n = min(100, Hh)
    e = max(err(kr[0][:n], pr[0][:n], "rel"), err(kr[1][:n], pr[1][:n], "rel"),
            err(kr[2][:n], pr[2][:n], "rel"), key=lambda x: x[1])
    rows["rollout"] = dict(err=e, bitwise=outputs_gap(kr, pr)[0],
                           bound=rollout_bound(s, Hh, Bb))
    note(task, "rollout", rows)
    if at_limits:
        act = limits_active(task.model, pr[0][:Hh].transpose(0, 1))  # (H, B)
        rows["active"] = dict(lane_steps=int(act.sum()), of=act.numel(),
                              lanes=int(act.any(0).sum()))
        print(f"  {task.name}: limit rows active in {rows['active']['lane_steps']}"
              f" of {act.numel()} lane-steps of the plain rollout, "
              f"{rows['active']['lanes']} of {Bb} lanes", flush=True)
        check(rows["active"]["lane_steps"] > 0,
              f"{task.name}: no limit row was ever active in the check")
    if task.model.contact_pairs:
        c = rows["contacts"] = contact_counts(task, pr[0][:Hh])
        print(f"  {task.name}: contact rows active, per pair "
              f"{[f'{a}-{b}' for a, b in task.model.contact_pairs]}, in "
              f"{c['lane_steps_by_pair']} of {c['of']} lane-steps and "
              f"{c['lanes_by_pair']} of {Bb} lanes of the plain rollout",
              flush=True)
        if pair_types:
            kinds = [pr.types for pr in contact_constants(task.model).pairs]
            c["lane_steps_by_type"] = {
                f"{t1}-{t2}": sum(n_ for n_, k in zip(
                    c["lane_steps_by_pair"], kinds) if k == (t1, t2))
                for t1, t2 in sorted(set(kinds))}
            print(f"  {task.name}: contact rows active per pair type (geom "
                  f"types): {json.dumps(c['lane_steps_by_type'])} lane-steps",
                  flush=True)
            check(all(n_ > 0 for n_ in c["lane_steps_by_type"].values()),
                  f"{task.name}: a contact pair type was never active")
        else:
            check(all(n_ > 0 for n_ in c["lane_steps_by_pair"]),
                  f"{task.name}: a contact pair was never active in the "
                  "check")
    if task.init_controls_fn is not None:
        rows["fk_bias"] = check_fk_bias(task, pr[0][:Hh], pr[1][:Hh])
    if time_them:
        rows["rollout"]["ms"] = cuda_ms(lambda: ops.rollout(task, qp0, qv0, U, tg), 5)
        rows["rollout"]["plain_ms"] = plain_ms

    # K4 line search, about the kernel rollout's nominal
    qpos, qvel = kr[0], kr[1]
    kl = ops.linesearch(task, qpos, qvel, U, k, K, alphas, tg)
    pl, plain_ms = twin("linesearch", lambda: ops.linesearch(
        task, qpos, qvel, U, k, K, alphas, tg, plain=True))
    e = max(err(kl[0][:n], pl[0][:n], "rel"), err(kl[2][:n], pl[2][:n], "rel"),
            err(kl[3][:n], pl[3][:n], "rel"), key=lambda x: x[1])
    rows["linesearch"] = dict(
        err=e, bitwise=outputs_gap(kl, pl)[0],
        bound=linesearch_bound(s, Hh, len(alphas), Bb))
    note(task, "linesearch", rows)
    if time_them:
        rows["linesearch"]["ms"] = cuda_ms(
            lambda: ops.linesearch(task, qpos, qvel, U, k, K, alphas, tg), 5)
        rows["linesearch"]["plain_ms"] = plain_ms

    # K5ad at every step (SI_1) and K7: for the toys on the nominal their
    # main path starts from (zero controls on these scenes), with constraint
    # rows along the rollout above
    U0 = U if gated else torch.zeros_like(U)
    q0, v0, _ = ops.rollout(task, qp0, qv0, U0, tg)
    kj = ops.ad_jacobian(task, q0, v0, U0, plan.times)
    pj, plain_ms = twin("ad_jacobian", lambda: ops.ad_jacobian(
        task, q0, v0, U0, plan.times, plain=True))
    modes = ad_modes_check(task, q0, v0, U0,
                           plain and plain["ad_jacobian_modes"])
    rows["ad_jacobian"] = dict(
        err=max([err(kj, pj, "rel")] + [(g, g / max(float(pj.abs().max()),
                                                   1e-300))
                                       for _, g in modes.values()],
                key=lambda x: x[1]),
        bitwise=bool(torch.equal(kj, pj)) and all(m[0] for m in
                                                   modes.values()),
        modes={k: dict(bitwise=v[0], max_abs_err=v[1])
               for k, v in modes.items()},
        bound=ad_bound(s, len(plan.times), Bb))
    note(task, "ad_jacobian", rows)
    print(f"  {task.name} ad_jacobian: shared slots bitwise "
          f"{bool(torch.equal(kj, pj))}, per-lane slots and the cache "
          f"(bitwise, max abs err) {json.dumps(modes)}", flush=True)
    del pj
    if time_them:
        rows["ad_jacobian"]["ms"] = cuda_ms(lambda: ops.ad_jacobian(
            task, q0, v0, U0, plan.times), 5)
        rows["ad_jacobian"]["plain_ms"] = plain_ms

    # K6 on the nominal the backward pass below reads
    l = ops.cost_expansion(task, q0, v0, U0, tg)
    pc, plain_ms = twin("cost_expansion", lambda: ops.cost_expansion(
        task, q0, v0, U0, tg, plain=True))
    rows["cost_expansion"] = dict(
        err=max((err(a, b, "rel") for a, b in zip(l, pc)),
                key=lambda x: x[1]),
        bitwise=all(bool(torch.equal(a, b)) for a, b in zip(l, pc)),
        bound=cost_expansion_bound(s, Hh, Bb))
    note(task, "cost_expansion", rows)
    del pc
    if time_them:
        rows["cost_expansion"]["ms"] = cuda_ms(lambda: ops.cost_expansion(
            task, q0, v0, U0, tg), 5)
        rows["cost_expansion"]["plain_ms"] = plain_ms

    A, Bm = lanes.jacobians_si(task, plan, q0, v0, U0,
                               lanes.slot_jacobians(task, "ad"))
    lam = torch.full((Bb,), cfg.lambda_init, dtype=torch.float64,
                     device="cuda")
    info = {}
    kb = ops.backward(A, Bm, *l, lam, cfg, info=info)
    pb, plain_ms = twin("backward", lambda: ops.backward(A, Bm, *l, lam, cfg,
                                                         plain=True))
    # λ and λ-exit decide the next iteration: they must agree bit for bit
    bad = ((kb[4] != pb[4]) | (kb[3] != pb[3])).nonzero().flatten()[:5]
    check(len(bad) == 0,
          f"{task.name} backward: λ or λ-exit differ in lanes {bad.tolist()}: "
          f"kernel λ {kb[3][bad].tolist()} exit {kb[4][bad].tolist()}, plain λ "
          f"{pb[3][bad].tolist()} exit {pb[4][bad].tolist()}; kernel gains "
          f"finite {torch.isfinite(kb[0][..., bad]).all(0).all(0).tolist()}")
    live = ~pb[4]                      # a λ-exit lane's gains are not used
    e = max(err(kb[0][..., live], pb[0][..., live], "rel"),
            err(kb[1][..., live], pb[1][..., live], "rel"),
            err(kb[2][live], pb[2][live], "rel"), key=lambda x: x[1])
    sweeps = bp_sweeps(info)
    wit = order_witness(A, Bm, l, lam, cfg, kb)
    check_orders(task.name, wit)
    rows["backward"] = dict(err=e, orders=wit, sweeps=sweeps, retried=float(
        (kb[3] > lam / cfg.lambda_factor * 1.5).double().mean()),
        bitwise=all(same_values(a, b) for a, b in zip(
            [x[..., live] for x in kb[:2]] + [kb[2][live]],
            [x[..., live] for x in pb[:2]] + [pb[2][live]])),
        bound=backward_bound(s.nx, s.nu, Hh, Bb, sweeps))
    note(task, "backward", rows)
    if time_them:
        rows["backward"]["ms"] = cuda_ms(lambda: ops.backward(A, Bm, *l, lam,
                                                              cfg), 5)
        rows["backward"]["plain_ms"] = plain_ms

    for name in LANE_KERNELS:
        row = rows[name]
        kind, tol = TOL[name]
        got = row["err"][1]
        if name in ("cost_expansion", "backward") or exact:
            check(row["bitwise"], f"{task.name} {name}: kernel vs plain "
                                  f"not bit for bit (error {got:.3e})")
            row["tol"] = "bit for bit"
            continue
        check(math.isfinite(got) and got <= tol,
              f"{task.name} {name}: kernel vs plain error {got:.3e} > {kind} "
              f"{tol:.0e}")
        row["tol"] = f"{kind} {tol:.0e}"
    if exact and "fk_bias" in rows:
        check(rows["fk_bias"]["bitwise"], f"{task.name} fk_bias: kernel vs "
                                          "plain not bit for bit")
        rows["fk_bias"]["tol"] = "bit for bit"
    return rows


def check_fd(task, q0, v0, U0, times, time_it=True, plain=None):
    """K5 (central FD) against its twin at shared slot times and at per-lane
    slots with live counts, bit for bit (the twin's outputs `plain` from
    fd_twins, or run here) -> row."""
    s = Sizes(task)
    Bb = U0.shape[-1]
    kj = ops.fd_jacobian(task, q0, v0, U0, times, 1e-6)
    slot_t, counts = lane_slots(U0.shape[0], Bb, seed=6)
    kl = ops.fd_jacobian(task, q0, v0, U0, slot_t, 1e-6, counts=counts)
    pj, plain_ms, pl = plain or fd_twins(task, q0, v0, U0, times)
    row = dict(err=max(err(kj, pj, "abs"), err(kl, pl, "abs")),
               bitwise=bool(torch.equal(kj, pj)) and bool(torch.equal(kl, pl)),
               modes={"per_lane": outputs_gap(kl, pl)}, plain_ms=plain_ms,
               bound=fd_bound(s, len(times), Bb), tol="bit for bit")
    if time_it:
        row["ms"] = cuda_ms(lambda: ops.fd_jacobian(task, q0, v0, U0, times,
                                                    1e-6), 3)
    print(f"  {task.name} fd_jacobian: kernel vs plain max abs err "
          f"{row['err'][0]:.3e}, bitwise {row['bitwise']} (shared slots and "
          f"per-lane slots)", flush=True)
    check(row["bitwise"], f"{task.name} fd_jacobian: kernel vs plain not bit "
                          f"for bit ({row['err'][0]:.3e})")
    return row


def twin_outputs(task, inputs):
    """The twins of check_kernels's K3, K4, K5ad, K6 and K7 calls on
    `inputs` for a task with constraint rows (its Jacobians taken along the
    rollout itself), each on the twins' own chain, with their device ms ->
    {name: (outputs, ms)}, and K5ad's in its other slot modes (ad_modes).
    They launch no kernel, so the gated checks run them beside the build
    (check_worker)."""
    qp0, qv0, tg, U, k, K = inputs
    Hh, Bb = U.shape[0], U.shape[-1]
    cfg = ILQRConfig()
    alphas = ilqr.default_alphas(cfg.num_parallel_rollouts, device="cuda")
    plan = lanes.si_plan(si1(task), Hh)
    out = {"rollout": cuda_timed(lambda: ops.rollout(task, qp0, qv0, U, tg,
                                                     plain=True))}
    q0, v0 = out["rollout"][0][:2]
    out["linesearch"] = cuda_timed(lambda: ops.linesearch(
        task, q0, v0, U, k, K, alphas, tg, plain=True))
    out["ad_jacobian"] = cuda_timed(lambda: ops.ad_jacobian(
        task, q0, v0, U, plan.times, plain=True))
    out["ad_jacobian_modes"] = ad_modes(task, q0, v0, U, plain=True)
    out["cost_expansion"] = cuda_timed(lambda: ops.cost_expansion(
        task, q0, v0, U, tg, plain=True))
    J = out["ad_jacobian"][0]
    A, Bm = lanes.jacobians_si(task, plan, q0, v0, U, lambda *a, **kw: J)
    lam = torch.full((Bb,), cfg.lambda_init, dtype=torch.float64,
                     device="cuda")
    out["backward"] = cuda_timed(lambda: ops.backward(
        A, Bm, *out["cost_expansion"][0], lam, cfg, plain=True))
    return out


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(_to(y, dev) for y in x) if not hasattr(x, "_fields") \
            else type(x)(*(_to(y, dev) for y in x))
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x


def check_case(name):
    """(task, inputs) of a kernel check whose twins run beside the build:
    pentabot, reaching (half its lanes at their limits) and the walker at
    their check sizes, the box tasks at SI_1 on box_inputs, the clutter
    tasks at SI_1 on clutter_inputs (CH, CB)."""
    if name == "pentabot":
        t = make_pentabot(device="cuda")
        return t, pentabot_inputs(t, PH, PB, seed=3)
    if name == "reaching":
        t = make_reaching(device="cuda")
        return t, lane_inputs(t, PH, PB, seed=3, at_limits=True)
    if name == "walker":
        t = make_walker(run=True, device="cuda")
        return t, walker_inputs(t, WH, WB, seed=3)
    if name in CLUTTER:
        t = si1(pushing.make_pushing(CLUTTER[name], device="cuda"))
        return t, clutter_inputs(t, CH, CB, seed=3)
    if name == "push_ncl":
        # push_inputs, saved by the main process from its kernel servo
        t = si1(pushing.make_pushing(device="cuda"))
        return t, _to(torch.load(PUSH_INPUTS), "cuda")
    t = si1({"box_sweep": manipulation.make_box_sweep,
             "threeD_push": manipulation.make_threed_push}[name](
                 device="cuda"))
    return t, box_inputs(t, PH, PB, seed=3)


# the twins beside the build, one process each (check_worker), the longest
# first
CHECK_WORKERS = ("push_lcl", "push_ccl", "pentabot,reaching,walker",
                 "step_instances",
                 "box_sweep", "threeD_push", "box_sweep_3it")


def check_worker(names, path):
    """`--plain-check-worker NAMES PATH`: the plain halves (twin_outputs) of
    the kernel checks NAMES (comma-separated, check_case), or for
    box_sweep_3it of box_sweep's 3-iteration hold (its servo's first BH3
    controls at BB lanes from the twins of fk_bias and K3, then the plain
    3-iteration solve at PB lanes), saved to PATH.  It launches no kernel,
    so it runs beside the build, in a process of its own (CHECK_WORKERS
    side by side)."""
    if names == "step_instances":
        torch.save({names: _to(step_twins(), "cpu")}, path)
        return
    if names != "box_sweep_3it":
        out = {}
        for name in names.split(","):
            task, inputs = check_case(name)
            tw = twin_outputs(task, inputs)
            if name in ("box_sweep", "threeD_push") or name in CLUTTER:
                # the box and clutter checks hold K5 too (the CLI's generic
                # solve)
                q0, v0 = tw["rollout"][0][:2]
                tw["fd_jacobian"] = fd_twins(
                    task, q0, v0, inputs[3],
                    lanes.si_plan(task, inputs[3].shape[0]).times)
            out[name] = _to(tw, "cpu")
        torch.save(out, path)
        return
    out = {}
    box = manipulation.make_box_sweep(device="cuda")
    t1 = si1(box)
    qp, qv, tg = manipulation.box_scenes(t1, BB, seed=0)
    t0 = time.perf_counter()
    path_, angle = pushing.ee_waypoint_path(t1, BH, qp.T.contiguous(),
                                            tg.T.contiguous())
    U, _, _ = pushing.servo_along_path(t1, path_[:BH3], angle,
                                       qp.T.contiguous(), qv.T.contiguous(),
                                       tg.T.contiguous(), plain=True)
    cfg3 = ILQRConfig(max_iterations=3, min_iterations=3)
    U3 = U.permute(2, 0, 1)[:PB].contiguous()
    r = lanes.make_lane_phase_optimise(t1, cfg3, BH3, plain=True)(
        qp[:PB], qv[:PB], U3, tg[:PB])
    torch.cuda.synchronize()
    out["box_sweep_3it"] = (_to(tuple(r), "cpu"), time.perf_counter() - t0,
                            U3.cpu())
    torch.save(out, path)


def bp_launches(kname, cfg):
    """Launches per call of a kernel wrapper: K7's first sweep and its
    bp_rounds retry rounds (each exits at once unless a lane retries), one
    for the others."""
    return 1 + ilqr.bp_rounds(cfg) if kname == "backward" else 1


def bp_sweeps(info):
    """Sweeps per lane of one backward pass: the first and one per retry
    round (every lane sweeps again in each, the coupled λ loop)."""
    return 1 + int(info["rounds"])


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


def stepwise_check(task, qp0, qv0, tgl, U, k, K, alphas, plan, A, Bm, l, lam,
                   cfg, fd_chunk=250, steps=None):
    """Every kernel against its twin at the main path's full shape, for a
    model whose twin is too slow to roll out the whole horizon (reaching: a
    twin step is thousands of launches).  The cost expansion and the
    backward pass are compared whole.  The rollout and line-search
    kernels are compared step by step: the twin's step, control law and
    cost run once over all (time, lane) pairs of the kernel's own
    trajectory, and each must give the kernel's next state, control and
    cost; equal single steps from equal states make equal rollouts.  With
    `steps`, only the first `steps` steps of every lane are compared, and
    the exact Jacobians (K5ad, launched at all slots) at the slots among
    them; else every step and slot.  Returns (max abs err, compared err)
    per kernel."""
    model, sv = task.model, task.sv
    Hh = U.shape[0]
    S = steps or Hh
    out = {}

    def costs_of(q, v, u, tg):
        """(nres-row residual over (n, S, ...)) -> costs (S, ...)."""
        r = task.residual_fn(q, v, u, tg)
        run = ilqr.step_cost(task, r[:, :Hh - 1], 0, 2)
        if r.shape[1] < Hh:
            return run
        return torch.cat([run, ilqr.step_cost(task, r[:, Hh - 1:], 0, 1)])

    def worst(pairs):
        return max((err(a, b, "rel") for a, b in pairs), key=lambda x: x[1])

    # K3: time as a lane axis, (n, H, B)
    qpos, qvel, costs = ops.rollout(task, qp0, qv0, U, tgl)
    q, v, u = (x[:S].transpose(0, 1) for x in (qpos, qvel, U))
    qn, vn = step_state(model, q, v, u)
    out["rollout"] = worst((
        (qpos[1:S + 1], qn.transpose(0, 1)),
        (qvel[1:S + 1], vn.transpose(0, 1)),
        (costs[:S], costs_of(q, v, u, tgl[:, None, :]))))

    # K4: (n, H, A, B); the control law of forward_pass_rollouts
    qps, qvs, us, cs = ops.linesearch(task, qpos, qvel, U, k, K, alphas, tgl)
    qps, qvs, us, cs = qps[:S + 1], qvs[:S + 1], us[:S], cs[:S]
    q, v = qps[:S].transpose(0, 1), qvs[:S].transpose(0, 1)
    dx = to_tangent(model, sv, q, v, qpos[:S].transpose(0, 1)[:, :, None, :],
                    qvel[:S].transpose(0, 1)[:, :, None, :])
    Kt = K[:S].transpose(0, 1)                          # (nu, S, 2n, B)
    fb = Kt[:, :, 0, None, :] * dx[0]
    for j in range(1, dx.shape[0]):
        fb = fb + Kt[:, :, j, None, :] * dx[j]
    lim = control_limits(task)
    u = (U[:S].transpose(0, 1)[:, :, None, :] + alphas[None, None, :, None]
         * k[:S].transpose(0, 1)[:, :, None, :] + fb)
    u = torch.minimum(torch.maximum(u, lim[:, 0, None, None, None]),
                      lim[:, 1, None, None, None])
    del dx, fb
    # the twin's step from the kernel's own controls, so that a control
    # difference is reported once, as one; one alpha at a time (the twin's
    # constraint solve over all of them would not fit the card at nx 26)
    uk = us.transpose(0, 1)
    steps = [step_state(model, q[:, :, a].contiguous(),
                        v[:, :, a].contiguous(), uk[:, :, a].contiguous())
             for a in range(len(alphas))]
    qn = torch.stack([x[0] for x in steps], 2)
    vn = torch.stack([x[1] for x in steps], 2)
    del steps
    out["linesearch"] = worst((
        (uk, u), (qps[1:], qn.transpose(0, 1)), (qvs[1:], vn.transpose(0, 1)),
        (cs, costs_of(q, v, uk, tgl[:, None, None, :]))))
    del qps, qvs, us, cs, q, v, u, uk, qn, vn

    # K5ad at every slot, the twin at the slots of the first S steps in
    # chunks of slots (it steps 2n + nu dual copies)
    kj = ops.ad_jacobian(task, qpos, qvel, U, plan.times)
    n_slots = int((plan.times < S).sum())
    kj = kj[:n_slots]
    pj = torch.cat([ops.ad_jacobian(task, qpos, qvel, U,
                                    plan.times[i:min(i + fd_chunk, n_slots)],
                                    plain=True)
                    for i in range(0, n_slots, fd_chunk)])
    out["ad_jacobian"] = err(kj, pj, "rel")
    out["ad_bitwise"] = bool(torch.equal(kj, pj))
    del kj, pj

    # K6 whole, bit for bit
    kc = ops.cost_expansion(task, qpos, qvel, U, tgl)
    pc = ops.cost_expansion(task, qpos, qvel, U, tgl, plain=True)
    out["cost_expansion"] = worst(zip(kc, pc))
    out["cost_expansion_bitwise"] = all(bool(torch.equal(a, b))
                                        for a, b in zip(kc, pc))
    del kc, pc

    # K7 whole
    kb = ops.backward(A, Bm, *l, lam, cfg)
    pb = ops.backward(A, Bm, *l, lam, cfg, plain=True)
    live = ~pb[4]
    check(bool(torch.equal(kb[4], pb[4])) and bool(torch.equal(kb[3], pb[3])),
          f"{task.name} backward at the full shape: λ or λ-exit differ")
    out["backward"] = worst(((kb[0][..., live], pb[0][..., live]),
                             (kb[1][..., live], pb[1][..., live]),
                             (kb[2][live], pb[2][live])))
    check(all(same_values(a, b) for a, b in (
        (kb[0][..., live], pb[0][..., live]),
        (kb[1][..., live], pb[1][..., live]), (kb[2][live], pb[2][live]))),
        f"{task.name} backward at the full shape: not bit for bit "
        f"({out['backward'][1]:.3e})")
    del pb
    out["backward_orders"] = order_witness(A, Bm, l, lam, cfg, kb)
    check_orders(f"{task.name} at the full shape", out["backward_orders"])
    return out


def si1(task):
    return task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name="set_interval", min_N=1))


def plain_3it(task, Hh, Bb, H3):
    """(result, seconds) of the plain path's 3-iteration solve of main_path
    for a task without initial controls (its scenes, zero controls): it
    launches no kernel, so it runs while the kernels build."""
    task = si1(task)
    B3 = Bb if task.name == "acrobot" else PB  # the arm tasks: PB lanes
    qp, qv, tg = lanes.scenes(task, Bb, seed=0)
    U3 = torch.zeros((B3, H3, task.model.nu), dtype=torch.float64,
                     device="cuda")
    cfg3 = ILQRConfig(max_iterations=3, min_iterations=3)
    t0 = time.perf_counter()
    r = lanes.make_lane_phase_optimise(task, cfg3, H3, plain=True)(
        qp[:B3], qv[:B3], U3, tg[:B3])
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def initial_nominal(task, qp0, qv0, tgl, U):
    """A main path's first iteration at its initial nominal (qp0 (nq, B),
    U (H, nu, B), lanes last): the rollout, the exact Jacobians at SI_1
    slots, the cost expansion and the backward pass -> dict."""
    Hh, Bb = U.shape[0], U.shape[-1]
    cfg = ILQRConfig()
    n = dict(cfg=cfg, plan=lanes.si_plan(task, Hh), info={},
             alphas=ilqr.default_alphas(cfg.num_parallel_rollouts,
                                        device="cuda"),
             jac=lanes.slot_jacobians(task, "ad"),
             lam=torch.full((Bb,), cfg.lambda_init, dtype=torch.float64,
                            device="cuda"))
    n["qpos"], n["qvel"], n["costs"] = ops.rollout(task, qp0, qv0, U, tgl)
    n["A"], n["Bm"] = lanes.jacobians_si(task, n["plan"], n["qpos"],
                                         n["qvel"], U, n["jac"])
    n["l"] = ops.cost_expansion(task, n["qpos"], n["qvel"], U, tgl)
    n["k"], n["K"] = ops.backward(n["A"], n["Bm"], *n["l"], n["lam"], cfg,
                                  info=n["info"])[:2]
    return n


def full_shape(task, Hh, Bb):
    """`--deep`: a main path's kernels against their twins at its own shape
    on its initial nominal (its scenes and zero controls, or its servo's
    start), printed and checked: stepwise_check, over the first
    CLUTTER_STEPS steps and slots at the clutter tasks (their twins' steps
    take seconds), and for a task with a servo fk_bias at every (time,
    lane) state of the nominal."""
    task = si1(task)
    if task.init_controls_fn is None:
        qp0, qv0, tgl = (x.T.contiguous()
                         for x in lanes.scenes(task, Bb, seed=0))
        U = torch.zeros((Hh, task.model.nu, Bb), dtype=torch.float64,
                        device="cuda")
    else:
        st = start_of(task, Hh, Bb)
        qp0, qv0, tgl, U = st["qpos"], st["qvel"], st["targets"], st["U"]
    n = initial_nominal(task, qp0, qv0, tgl, U)
    clutter = task.name in CLUTTER
    t0 = time.perf_counter()
    full = stepwise_check(task, qp0, qv0, tgl, U, n["k"], n["K"], n["alphas"],
                          n["plan"], n["A"], n["Bm"], n["l"], n["lam"],
                          n["cfg"],
                          fd_chunk=(500 if not task.model.contact_pairs else
                                    CLUTTER_CHUNK if clutter else
                                    100 if task.sv.nx > 20 else 200),
                          steps=CLUTTER_STEPS if clutter else None)
    if task.init_controls_fn is not None:
        fk = check_fk_bias(task, n["qpos"][:Hh], n["qvel"][:Hh])
        full["fk_bias"] = fk["err"]
        full["fk_bias_bitwise"] = fk["bitwise"]
    full["seconds"] = time.perf_counter() - t0
    full["steps_held"] = CLUTTER_STEPS if clutter else Hh
    print(f"  {task.name} kernels vs twins at H={Hh} B={Bb} (rollout and "
          f"line search step by step, over {full['steps_held']} steps): "
          f"{json.dumps(full)}", flush=True)
    for kname in LANE_KERNELS:
        kind, tol = TOL[kname]
        got = full[kname][1]
        check(math.isfinite(got) and got <= tol,
              f"{task.name} {kname} at the full shape: kernel vs plain "
              f"error {got:.3e} > {kind} {tol:.0e}")
    check(full["cost_expansion_bitwise"], f"{task.name} cost_expansion "
          "at the full shape: not bit for bit")
    return full


def box_keypoints(task):
    """K9a and K9b at box_sweep's main-path shape (BH, BB) with the CLI's
    own method (AJ_1_1000), on the nominal of its init servo, against their
    twins bit for bit with ms and bounds (check_plan; K5ad at per-lane
    slots is held against its twin at the box check)."""
    st = start_of(task, BH, BB)
    U = st["U"]
    qpos, qvel, _ = ops.rollout(task, st["qpos"], st["qvel"], U,
                                st["targets"])
    cfg = ILQRConfig()
    kc = task.keypoint_cfg
    label = f"box_sweep {method_tag(kc.name, kc.min_N, kc.max_N)}"
    ops.reset_launch_counts()
    row = check_plan(label, task, qpos, qvel, U,
                     lanes.kp_budget(cfg, task, BH), cfg, hold_ad=False)
    row["launches"] = {k: ops.LAUNCHES[k] for k in ops.KEYPOINT_KERNELS}
    print(f"  keypoints {label} at H={BH} B={BB}: {json.dumps(row)}",
          flush=True)
    return row


def main_path(task, Hh, Bb, H3, time_kernels, warmup_iters=ITERS,
              plain3=None, iters=ITERS):
    """One batched solve of `iters` iterations through the entry point with
    launch counts, the per-phase device times at the initial nominal, and,
    when H3 is given, 3 iterations of the kernel path against the plain
    path on the card at horizon H3 (`hold_3it`; `plain3`, that plain solve
    from plain_3it, when it ran beside the build).  Scenes: lanes.scenes
    and zero controls, or for a task with initial controls (pushing, the
    box tasks) its scene generator and servo (start_of, timed; its first
    SERVO_CHECKS steps held against the plain servo).  A warm-up solve of
    `warmup_iters` iterations runs first.  With `time_kernels` the kernels
    are timed at this shape (nominal_phases; `--deep` holds them against
    their twins there, full_shape)."""
    task = si1(task)
    name = task.name
    servo = None
    if task.init_controls_fn is None:
        qp, qv, tg = lanes.scenes(task, Bb, seed=0)
        U0 = torch.zeros((Bb, Hh, task.model.nu), dtype=torch.float64,
                         device="cuda")
    else:
        st = start_of(task, Hh, Bb)
        qp, qv = st["qpos"].T.contiguous(), st["qvel"].T.contiguous()
        tg = st["targets"].T.contiguous()
        U0 = st["U"].permute(2, 0, 1).contiguous()
        servo = dict(s=st["servo_s"], launches=st["launches"])
        steps = (f"{pushing.SETUP_STEPS} + {Hh}"
                 if task.residual_kind[0] == "push" else f"{Hh}")
        print(f"  {name}: servo for {Bb} scenes, {steps} steps: "
              f"{st['servo_s']:.3f} s, launches "
              f"{json.dumps(st['launches'])}", flush=True)
    if warmup_iters:
        lanes.make_lane_phase_optimise(                # warm-up
            task, ILQRConfig(max_iterations=warmup_iters,
                             min_iterations=warmup_iters), Hh)(qp, qv, U0,
                                                               tg)
    run = lanes.make_lane_phase_optimise(
        task, ILQRConfig(max_iterations=iters, min_iterations=iters), Hh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(qp, qv, U0, tg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    red = res.cost_reduction
    check(bool(torch.isfinite(red).all())
          and bool(torch.isfinite(res.final_cost).all()),
          f"{name} main path: non-finite costs")
    mean_red = float(red.mean())
    check(0.0 < mean_red < 1.0,
          f"{name} main path: mean cost reduction {mean_red}")
    for kname in LANE_KERNELS:
        check(launches[kname] > 0, f"{name} main path never launched {kname}")
    check(launches["fd_jacobian"] == 0,
          f"{name} main path launched the FD kernel: the lane path's "
          "Jacobians are K5ad's")
    # K6 runs once per derivative evaluation, as K5ad does (ten at acrobot)
    check(launches["cost_expansion"] == launches["ad_jacobian"],
          f"{name} main path launched cost_expansion "
          f"{launches['cost_expansion']} times, ad_jacobian "
          f"{launches['ad_jacobian']}")
    servo_check = (check_servo(task, st, Hh,
                               SERVO_CHECKS.get(name, SERVO_CHECK))
                   if servo else None)
    out = dict(mean_cost_reduction=mean_red, wall_s=wall,
               solves_per_s=Bb / wall, launches=launches, iterations=iters,
               iterations_mean=float(res.num_iterations.double().mean()),
               peak_memory_bytes=peak, servo=servo, servo_check=servo_check)
    out.update(nominal_phases(task, qp, qv, U0, tg, time_kernels))
    torch.cuda.empty_cache()
    if H3 is not None:
        out.update(hold_3it(task, qp, qv, U0, tg, H3, Bb, plain3))
    return out


def nominal_phases(task, qp, qv, U0, tg, time_kernels):
    """A main path's per-phase device times at its initial nominal (qp (B,
    nq), U0 (B, H, nu)), and with `time_kernels` each kernel's alone with
    its bound.  The timing runs with this script's workers stopped
    (card_alone) -> dict."""
    Hh, Bb = U0.shape[1], U0.shape[0]
    s = Sizes(task)
    qp0, qv0, tgl = qp.T.contiguous(), qv.T.contiguous(), tg.T.contiguous()
    U = U0.permute(1, 2, 0).contiguous()
    nom = initial_nominal(task, qp0, qv0, tgl, U)
    cfg, plan, alphas, jac, lam, info = (nom[x] for x in (
        "cfg", "plan", "alphas", "jac", "lam", "info"))
    qpos, qvel, A, Bm, l, k, K = (nom[x] for x in (
        "qpos", "qvel", "A", "Bm", "l", "k", "K"))
    active = limits_active(task.model, qpos[:Hh].transpose(0, 1))
    contacts = (contact_counts(task, qpos[:Hh]) if task.model.contact_pairs
                else None)
    old = nom["costs"].sum(0)
    with card_alone() as paused:
        phases = {
            "rollout": phase_ms(lambda: ops.rollout(task, qp0, qv0, U, tgl)),
            "jacobians": phase_ms(lambda: lanes.jacobians_si(
                task, plan, qpos, qvel, U, jac)),
            "cost_expansion": phase_ms(lambda: ops.cost_expansion(
                task, qpos, qvel, U, tgl)),
            "bp": phase_ms(lambda: ops.backward(A, Bm, *l, lam, cfg)),
            "fp": phase_ms(lambda: lanes.forward_pass(
                task, qpos, qvel, U, k, K, alphas, tgl, old)),
        }
        # the four kernels alone at this path's shapes, from its nominal
        # (the rollout and bp phases above are these kernels' launches)
        kernel_ms = time_kernels and {
            "rollout": phases["rollout"],
            "linesearch": phase_ms(lambda: ops.linesearch(
                task, qpos, qvel, U, k, K, alphas, tgl)),
            "ad_jacobian": phase_ms(lambda: ops.ad_jacobian(
                task, qpos, qvel, U, plan.times)),
            "cost_expansion": phases["cost_expansion"],
            "backward": phases["bp"],
        }
    out = dict(phases_ms=phases, workers_stopped=paused,
               cost_expansion_bound=cost_expansion_bound(s, Hh, Bb),
               limit_active_lane_steps=int(active.sum()),
               contacts=contacts, bp_sweeps_first=bp_sweeps(info))
    if time_kernels:
        out["kernel_ms"] = kernel_ms
        out["bounds"] = {
            "rollout": rollout_bound(s, Hh, Bb),
            "linesearch": linesearch_bound(s, Hh, len(alphas), Bb),
            "ad_jacobian": ad_bound(s, len(plan.times), Bb),
            "cost_expansion": cost_expansion_bound(s, Hh, Bb),
            "backward": backward_bound(s.nx, s.nu, Hh, Bb,
                                       out["bp_sweeps_first"]),
        }
    return out


def hold_3it(task, qp, qv, U0, tg, H3, Bb, plain3=None):
    """3 iterations of the kernel path against the plain path on the card
    at horizon H3 from a main path's scenes (qp (B, nq), qv, U0 (B, H, nu),
    tg), acrobot at its Bb lanes, the arm tasks at PB; with constraint rows
    also the kernel path with the twin's backward pass, which must equal
    the plain path bit for bit."""
    name = task.name
    out = {}
    # 3 iterations: kernel path against the plain path on the card
    cfg3 = ILQRConfig(max_iterations=3, min_iterations=3)
    B3 = Bb if task.name == "acrobot" else PB  # the arm tasks: PB lanes
    U3 = U0[:B3, :H3].contiguous()
    r_k = lanes.make_lane_phase_optimise(task, cfg3, H3)(
        qp[:B3], qv[:B3], U3, tg[:B3])
    if plain3 is None:
        t0 = time.perf_counter()
        r_p = lanes.make_lane_phase_optimise(task, cfg3, H3, plain=True)(
            qp[:B3], qv[:B3], U3, tg[:B3])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    else:
        r_p, plain_s = plain3[:2]
        if len(plain3) > 2:
            # run beside the build from the plain servo's controls: they
            # must be the kernel servo's
            check(bool(torch.equal(plain3[2].to(U3.device), U3)),
                  f"{name}: the plain servo's controls differ from the "
                  "kernel servo's")
    diff = (r_k.cost_reduction - r_p.cost_reduction).abs()
    agree = float((diff < 1e-4).double().mean())
    worst = torch.argsort(diff, descending=True)[:8]
    print(f"  {name} 3-it kernel vs plain (H={H3}, B={B3}): lanes within "
          f"1e-8 {float((diff < 1e-8).double().mean()):.4f}, 1e-6 "
          f"{float((diff < 1e-6).double().mean()):.4f}, 1e-4 {agree:.4f}, "
          f"1e-2 {float((diff < 1e-2).double().mean()):.4f}; worst lanes "
          f"{worst.tolist()} kernel {r_k.cost_reduction[worst].tolist()} "
          f"plain {r_p.cost_reduction[worst].tolist()} (plain path "
          f"{plain_s:.1f} s)", flush=True)
    out.update(plain_agree_3it=agree, plain_agree_shape=f"H={H3} B={B3}",
               plain_3it_s=plain_s)
    if not task.model.has_constraints:
        check(agree >= 0.99, f"{name}: only {agree:.3f} of lanes agree with "
                             "the plain path within 1e-4")
        return out
    # With constraint rows the bar is REACHING_AGREE_TOL: rollout, line search
    # and K5ad agree with their twins bit for bit, so the whole difference
    # enters through the backward pass (~1e-15 per call), and the solve
    # amplifies it: reaching's l_uu = 0 leaves Q_uu = B'V'B + λI with λ down
    # to 1e-4 (push_ncl's control weight is 0 too), and a state difference
    # at an active limit or contact row flips gates in later steps.  The
    # run below shows it: the kernel path with only the backward pass taken
    # from the twin must equal the plain path exactly.
    agree3 = float((diff < REACHING_AGREE_TOL).double().mean())
    check(agree3 >= 0.99, f"{name}: only {agree3:.3f} of lanes agree with "
                          f"the plain path within {REACHING_AGREE_TOL:.0e}")
    r_h = lanes.make_lane_phase_optimise(task, cfg3, H3, plain={"backward"})(
        qp[:B3], qv[:B3], U3, tg[:B3])
    same = bool(torch.equal(r_h.final_cost, r_p.final_cost)
                and torch.equal(r_h.ctrl, r_p.ctrl))
    print(f"  {name} 3-it, kernels with the twin's backward pass vs plain: "
          f"bitwise equal {same}, max |d cost reduction| "
          f"{float((r_h.cost_reduction - r_p.cost_reduction).abs().max()):.3e}",
          flush=True)
    check(same, f"{name}: rollout, line search and K5ad kernels with the "
                "twin's backward pass do not reproduce the plain path")
    out.update(plain_agree_3it_loose=agree3, hybrid_bitwise=same)
    return out


# ---- the keypoint kernels (K9a, K9b, K9c) and K5 at per-lane slots --------

# (model, method, min_N, max_N) of the keypoints phase at the check size
KP_CASES = (("acrobot", "velocity_change", 1, 100),
            ("acrobot", "adaptive_jerk", 1, 50),
            ("acrobot", "adaptive_accel", 1, 50),
            ("acrobot", "iterative_error", 1, 50),
            ("pentabot", "adaptive_accel", 1, 10),
            ("reaching", "adaptive_jerk", 5, 100),
            ("push_ncl", "adaptive_jerk", 5, 100),
            ("walker", "velocity_change", 1, 20))
KP_TIGHT = 12          # the forced slot budget of the overflow case
# the adaptive main paths: acrobot with the reference campaign's methods,
# reaching with adaptive_jerk; each with the twins its 3 iterations are held
# against: acrobot's own method against the plain path, AJ and IE against
# the path whose keypoint kernels (K9a, K9b, K9c and K5ad) are the twins,
# which holds each of them inside the solve loop in ~1 s where the plain
# path takes ~40 s (its rollout, line-search and backward twins are held in
# main_acrobot and in the VC run)
KP_TWINS = frozenset(ops.KEYPOINT_KERNELS + ("ad_jacobian",))
# (the velocity_change path against the whole plain path runs in `--deep`)
ADAPTIVE_MAIN = (("acrobot", "adaptive_jerk", 1, 50, KP_TWINS),
                 ("acrobot", "velocity_change", 1, 200, KP_TWINS),
                 ("acrobot", "iterative_error", 1, 50, KP_TWINS),
                 ("reaching", "adaptive_jerk", 5, 100, None))
KP_SHORT = {"adaptive_jerk": "AJ", "adaptive_accel": "AA",
            "velocity_change": "VC", "iterative_error": "IE"}


def with_method(task, name, min_N, max_N, **extra):
    return task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name=name, min_N=min_N, max_N=max_N, **extra))


def method_tag(name, min_N, max_N):
    return f"{KP_SHORT[name]}_{min_N}_{max_N}"


def plan_bound(H_, n, Bb, K_max):
    """K9a: the state dofs' velocities read once and the plan written (mask
    1 byte, two slots 4 and the weight 8 per (t, dof); K_max slot times;
    count, overflow and pct), a few operations per (t, dof)."""
    byt = F8 * H_ * n * Bb + H_ * n * Bb * 17 + F8 * K_max * Bb + 16 * Bb
    return bound(10 * H_ * n * Bb, byt)


def interp_bound(live, H_, nx, C, n, Bb):
    """K9b: the live slots' Jacobians read once, the plan's slots and
    weights read once, A and Bm written; three operations per entry."""
    byt = F8 * live * nx * C + 16 * H_ * n * Bb + F8 * H_ * nx * C * Bb
    return bound(3 * H_ * nx * C * Bb, byt)


def mse_bound(times, m, n, Bb):
    """K9c: the velocity rows of the two columns of each dof at the nodes'
    distinct times read once, the mse written; ~8 operations per entry."""
    byt = F8 * times * n * 2 * n * Bb + 12 * m + F8 * m * n * Bb
    return bound(8 * m * n * n * Bb, byt)


def ad_lane_bound(s, live, K_max, Bb):
    """K5ad at per-lane slots: the live slots' work and bytes (ad_bound per
    live (slot, lane)), with the slot times and counts read."""
    nx, nc = s.nx, s.nx + s.nu
    ops_ = live * ad_slot_ops(s)
    byt = F8 * (live * (s.nq + s.nv + s.nu) + K_max * Bb * nx * nc
                + K_max * Bb) + 4 * Bb
    return bound(ops_, byt)


def ad_lane_plain(task, qpos, qvel, U, slot_t, count, chunk):
    """K5ad's per-lane twin over chunks of slots (it steps 2n + nu dual
    copies of every slot)."""
    outs = []
    for i in range(0, slot_t.shape[0], chunk):
        c = torch.clamp(count - i, 0, chunk).to(torch.int32)
        outs.append(ops.ad_jacobian(task, qpos, qvel, U,
                                    slot_t[i:i + chunk].contiguous(),
                                    plain=True, counts=c))
    return torch.cat(outs)


def hold(name, kern, plain):
    """(bit for bit, max abs err) of a kernel's outputs against its twin's;
    a difference is a failed check."""
    same, gap = outputs_gap(kern, plain)
    check(same, f"{name}: kernel differs from its twin by {gap:.3e}")
    return dict(bitwise=same, max_abs_err=gap)


def check_plan(label, task, qpos, qvel, U, K_max, cfg, time_it=True,
               fd_chunk=0, hold_ad=True):
    """K9a, K5ad at the plan's per-lane slots and K9b on the nominal (qpos,
    qvel, U), each against its twin bit for bit, with device ms, the
    twin's ms and the bounds (the live slots counted from this run);
    without `hold_ad` K5ad is timed alone (held where this is called
    from)."""
    Hh, Bb = U.shape[0], U.shape[-1]
    s = Sizes(task)
    n, nx, nc = task.sv.ndof, s.nx, s.nx + s.nu
    pa = ops.keypoint_plan_args(task)
    col = torch.as_tensor(lanes.column_dofs(n, s.nu), dtype=torch.int32,
                          device="cuda")
    kp = ops.keypoint_plan(pa, qvel, Hh, K_max)
    pp, plan_plain_ms = cuda_timed(
        lambda: ops.keypoint_plan(pa, qvel, Hh, K_max, plain=True))
    live = int(kp.count.sum())
    out = {"keypoint_plan": dict(
        hold(f"{label} keypoint_plan", kp, pp), plain_ms=plan_plain_ms,
        bound=plan_bound(Hh, n, Bb, K_max))}
    kj = ops.ad_jacobian(task, qpos, qvel, U, kp.slot_t, counts=kp.count)
    if not hold_ad:
        out["ad_jacobian"] = dict(bound=ad_lane_bound(s, live, K_max, Bb))
    elif fd_chunk:
        t0 = time.perf_counter()
        pj = ad_lane_plain(task, qpos, qvel, U, kp.slot_t, kp.count,
                           fd_chunk)
        torch.cuda.synchronize()
        ad_plain_ms = (time.perf_counter() - t0) * 1e3
    else:
        pj, ad_plain_ms = cuda_timed(lambda: ops.ad_jacobian(
            task, qpos, qvel, U, kp.slot_t, plain=True, counts=kp.count))
    if hold_ad:
        out["ad_jacobian"] = dict(
            hold(f"{label} ad_jacobian (per-lane slots)", kj, pj),
            plain_ms=ad_plain_ms, bound=ad_lane_bound(s, live, K_max, Bb))
        del pj
    ki = ops.kp_interp(kj, kp.pslot, kp.nslot, kp.w, col, nx)
    pi, interp_plain_ms = cuda_timed(lambda: ops.kp_interp(
        kj, kp.pslot, kp.nslot, kp.w, col, nx, plain=True))
    out["kp_interp"] = dict(hold(f"{label} kp_interp", ki, pi),
                            plain_ms=interp_plain_ms,
                            bound=interp_bound(live, Hh, nx, nc, n, Bb))
    del pi, ki
    if time_it:
        out["keypoint_plan"]["ms"] = cuda_ms(
            lambda: ops.keypoint_plan(pa, qvel, Hh, K_max), 3)
        out["ad_jacobian"]["ms"] = cuda_ms(lambda: ops.ad_jacobian(
            task, qpos, qvel, U, kp.slot_t, counts=kp.count), 3)
        out["kp_interp"]["ms"] = cuda_ms(lambda: ops.kp_interp(
            kj, kp.pslot, kp.nslot, kp.w, col, nx), 3)
    out.update(shape=f"H={Hh} B={Bb}", K_max=K_max, live_slots=live,
               overflow_max=int(kp.overflow.max()),
               pct_mean=float(kp.pct.mean()))
    return out


def check_ie(label, task, qpos, qvel, U, cfg):
    """iterative_error: the whole jacobians phase (K5ad into the cache, K9c,
    K9a with time slots, K9b) against its twins' phase bit for bit, and K9c
    alone on a full cache at the bisection tree's levels."""
    Hh, Bb = U.shape[0], U.shape[-1]
    n = task.sv.ndof
    ph = lanes.lane_phases(task, cfg, Hh)
    pp = lanes.lane_phases(task, cfg, Hh, plain=True)
    jk, phase_ms = cuda_timed(lambda: ph["jacobians"](qpos, qvel, U))
    mk = ph["keypoints"]["mask"]
    jp, phase_plain_ms = cuda_timed(lambda: pp["jacobians"](qpos, qvel, U))
    out = {"phase": dict(hold(f"{label} jacobians phase", (jk, mk),
                              (jp, pp["keypoints"]["mask"])),
                         ms=phase_ms, plain_ms=phase_plain_ms,
                         pct_mean=float(jk[2].mean()))}
    # K9c alone: a cache filled at every time, every level of the tree
    nx, C = task.sv.nx, task.sv.nx + task.model.nu
    cache = torch.zeros((Hh, nx, C, Bb), dtype=torch.float64, device="cuda")
    every = torch.arange(Hh, device="cuda")[:, None].expand(Hh, Bb)
    ops.ad_jacobian(task, qpos, qvel, U, every.contiguous(),
                    counts=torch.full((Bb,), Hh, dtype=torch.int32,
                                      device="cuda"), cache=cache)
    levels = lanes.ie_levels(Hh, max(task.keypoint_cfg.min_N, 1))
    gaps, ms, plain_ms, m_all, t_all = [], 0.0, 0.0, 0, 0
    for s_arr, mid_arr, e_arr, _ in levels:
        nodes = [torch.as_tensor(a, dtype=torch.int32, device="cuda")
                 for a in (s_arr, mid_arr, e_arr)]
        k9c = ops.ie_mse(cache, *nodes, n)
        p9c, pms = cuda_timed(lambda: ops.ie_mse(cache, *nodes, n,
                                                 plain=True))
        gaps.append(outputs_gap(k9c, p9c))
        ms += cuda_ms(lambda: ops.ie_mse(cache, *nodes, n), 3)
        plain_ms += pms
        m_all += len(s_arr)
        t_all += len(set(np.concatenate([s_arr, mid_arr, e_arr]).tolist()))
    same = all(g[0] for g in gaps)
    gap = max(g[1] for g in gaps)
    check(same, f"{label} ie_mse: kernel differs from its twin by {gap:.3e}")
    out["ie_mse"] = dict(bitwise=same, max_abs_err=gap, ms=ms,
                         plain_ms=plain_ms, levels=len(levels), nodes=m_all,
                         bound=mse_bound(t_all, m_all, n, Bb),
                         launches_timed=len(levels))
    return out


def keypoints_phase(tasks, inputs):
    """K9a, K5ad at per-lane slots, K9b and K9c against their twins on the
    card at the check size (PH, PB; the walker at WH, WB) for each case of
    KP_CASES from each model's check inputs (push_ncl from its servo), and
    one case under a forced small slot budget (overflow); reaching's and
    push_ncl's full shapes are held in `--deep` (keypoints_full_shapes).
    Returns the rows by case, each with the launches of each kernel in that
    case."""
    cfg = ILQRConfig()
    out = {}
    counted = ops.KEYPOINT_KERNELS + ("ad_jacobian",)
    for model, name, min_N, max_N in KP_CASES:
        ops.reset_launch_counts()
        task = with_method(tasks[model], name, min_N, max_N)
        qp0, qv0, tg, U = inputs[model][:4]
        qpos, qvel, _ = ops.rollout(task, qp0, qv0, U, tg)
        label = f"{model} {method_tag(name, min_N, max_N)}"
        t0 = time.perf_counter()
        if name == "iterative_error":
            row = check_ie(label, task, qpos, qvel, U, cfg)
        else:
            row = check_plan(label, task, qpos, qvel, U,
                             lanes.kp_budget(cfg, task, U.shape[0]), cfg)
        row["s"] = time.perf_counter() - t0
        row["launches"] = {k: ops.LAUNCHES[k] for k in counted}
        out[label] = row
        print(f"  keypoints {label} (H={U.shape[0]}, B={U.shape[-1]}): "
              f"{json.dumps(row)}", flush=True)
    # overflow: acrobot adaptive_jerk under KP_TIGHT slots
    task = with_method(tasks["acrobot"], "adaptive_jerk", 1, 50)
    qp0, qv0, tg, U = inputs["acrobot"][:4]
    qpos, qvel, _ = ops.rollout(task, qp0, qv0, U, tg)
    row = check_plan("acrobot AJ_1_50 overflow", task, qpos, qvel, U,
                     KP_TIGHT, cfg, time_it=False)
    check(row["overflow_max"] > 0, "the tight slot budget did not overflow")
    out["acrobot AJ_1_50 budget 12"] = row
    print(f"  keypoints acrobot AJ_1_50 under a budget of {KP_TIGHT} slots: "
          f"{json.dumps(row)}", flush=True)
    return out


def keypoints_full_shapes(tasks):
    """`--deep`: K9a, K5ad at per-lane slots and K9b at reaching's and
    push_ncl's full shapes, AJ_5_100 on their main paths' nominals, against
    their twins bit for bit (check_plan; K5ad's twin in chunks of slots)."""
    cfg = ILQRConfig()
    counted = ops.KEYPOINT_KERNELS + ("ad_jacobian",)
    out = {}
    for model, name, Hh, Bb, chunk in (("reaching", "adaptive_jerk", RH, RB,
                                        150),
                                       ("push_ncl", "adaptive_jerk", UH, UB,
                                        100)):
        task = with_method(si1(tasks[model]), name, 5, 100)
        if model == "push_ncl":
            st = push_start(task)
            qp0, qv0, tg, U = st["qpos"], st["qvel"], st["targets"], st["U"]
        else:
            qp, qv, tgb = lanes.scenes(task, Bb, seed=0)
            qp0, qv0, tg = (x.T.contiguous() for x in (qp, qv, tgb))
            U = torch.zeros((Hh, task.model.nu, Bb), dtype=torch.float64,
                            device="cuda")
        qpos, qvel, _ = ops.rollout(task, qp0, qv0, U, tg)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        row = check_plan(f"{model} AJ_5_100 full shape", task, qpos, qvel, U,
                         lanes.kp_budget(cfg, task, Hh), cfg,
                         fd_chunk=chunk)
        row["s"] = time.perf_counter() - t0
        row["launches"] = {k: ops.LAUNCHES[k] for k in counted}
        out[f"{model} AJ_5_100 full shape"] = row
        print(f"  keypoints {model} AJ_5_100 at H={Hh} B={Bb}: "
              f"{json.dumps(row)}", flush=True)
        del qpos, qvel
        torch.cuda.empty_cache()
    return out


def adaptive_path(task, Hh, Bb, plain3, start=None, iters=ITERS):
    """An adaptive keypoint main path: one batched solve of `iters`
    iterations through make_lane_phase_optimise (after a one-iteration
    warm-up) from lanes.scenes and zero controls, or from `start` (a main
    path's start, start_of), with launch counts, solves/s, mean cost
    reduction, mean %derivs and the largest overflow; the device ms of each
    phase at the initial nominal and of each kernel of the jacobians phase;
    with `plain3` 3 iterations of the kernel path against the path with
    those twins (True: the plain path; a set: those kernels as twins, the
    others as kernels), bit for bit."""
    name = task.name
    kp = task.keypoint_cfg
    if start is None:
        qp, qv, tg = lanes.scenes(task, Bb, seed=0)
        U0 = torch.zeros((Bb, Hh, task.model.nu), dtype=torch.float64,
                         device="cuda")
    else:
        qp, qv, tg = (start[k].T.contiguous()
                      for k in ("qpos", "qvel", "targets"))
        U0 = start["U"].permute(2, 0, 1).contiguous()
    lanes.make_lane_phase_optimise(
        task, ILQRConfig(max_iterations=1, min_iterations=1), Hh)(
            qp, qv, U0, tg)
    run = lanes.make_lane_phase_optimise(
        task, ILQRConfig(max_iterations=iters, min_iterations=iters), Hh)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(qp, qv, U0, tg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    red = res.cost_reduction
    mean_red = float(red.mean())
    check(bool(torch.isfinite(red).all()) and 0.0 < mean_red < 1.0,
          f"{name} {kp.name} main path: mean cost reduction {mean_red}")
    want = LANE_KERNELS + ("kp_interp", "keypoint_plan") + (
        ("ie_mse",) if kp.name == "iterative_error" else ())
    for kname in want:
        check(launches.get(kname, 0) > 0,
              f"{name} {kp.name} main path never launched {kname}")
    out = dict(mean_cost_reduction=mean_red, wall_s=wall,
               solves_per_s=Bb / wall, launches=launches,
               pct_derivs_mean=float(res.pct_derivs.mean()),
               kp_overflow_max=int(res.kp_overflow.max()),
               iterations_mean=float(res.num_iterations.double().mean()))
    # device ms per phase at the initial nominal
    cfg = ILQRConfig()
    s = Sizes(task)
    qp0, qv0, tgl = qp.T.contiguous(), qv.T.contiguous(), tg.T.contiguous()
    U = U0.permute(1, 2, 0).contiguous()
    ph = lanes.lane_phases(task, cfg, Hh)
    qpos, qvel, costs = ph["rollout"](qp0, qv0, U, tgl)
    A, Bm, pct, _ = ph["jacobians"](qpos, qvel, U)
    l = ph["cost_expansion"](qpos, qvel, U, tgl)
    lam = torch.full((Bb,), cfg.lambda_init, dtype=torch.float64,
                     device="cuda")
    k, K, *_ = ph["bp"](A, Bm, *l, lam)
    old = costs.sum(0)
    out["phases_ms"] = {
        "rollout": cuda_ms(lambda: ph["rollout"](qp0, qv0, U, tgl), 3),
        "jacobians": cuda_ms(lambda: ph["jacobians"](qpos, qvel, U), 3),
        "cost_expansion": cuda_ms(lambda: ph["cost_expansion"](
            qpos, qvel, U, tgl), 3),
        "bp": cuda_ms(lambda: ph["bp"](A, Bm, *l, lam), 3),
        "fp": cuda_ms(lambda: ph["fp"](qpos, qvel, U, old, k, K, tgl), 3),
    }
    out["pct_first"] = float(pct.mean())
    del A, Bm, l, k, K
    if kp.name != "iterative_error":
        # the kernels of the jacobians phase alone, with their bounds
        K_max = lanes.kp_budget(cfg, task, Hh)
        pa = ops.keypoint_plan_args(task)
        plan = ops.keypoint_plan(pa, qvel, Hh, K_max)
        live = int(plan.count.sum())
        J = ops.ad_jacobian(task, qpos, qvel, U, plan.slot_t,
                            counts=plan.count)
        col = torch.as_tensor(lanes.column_dofs(task.sv.ndof, s.nu),
                              dtype=torch.int32, device="cuda")
        out["kernel_ms"] = {
            "keypoint_plan": cuda_ms(lambda: ops.keypoint_plan(
                pa, qvel, Hh, K_max), 3),
            "ad_jacobian": cuda_ms(lambda: ops.ad_jacobian(
                task, qpos, qvel, U, plan.slot_t, counts=plan.count), 3),
            "kp_interp": cuda_ms(lambda: ops.kp_interp(
                J, plan.pslot, plan.nslot, plan.w, col, s.nx), 3),
        }
        # their twins at this shape (K5ad's: the keypoints phase, in chunks)
        out["plain_ms"] = {
            "keypoint_plan": cuda_timed(lambda: ops.keypoint_plan(
                pa, qvel, Hh, K_max, plain=True))[1],
            "kp_interp": cuda_timed(lambda: ops.kp_interp(
                J, plan.pslot, plan.nslot, plan.w, col, s.nx,
                plain=True))[1],
        }
        out["bounds"] = {
            "keypoint_plan": plan_bound(Hh, task.sv.ndof, Bb, K_max),
            "ad_jacobian": ad_lane_bound(s, live, K_max, Bb),
            "kp_interp": interp_bound(live, Hh, s.nx, s.nx + s.nu,
                                      task.sv.ndof, Bb),
        }
        out.update(K_max=K_max, live_slots_first=live)
        del J
    torch.cuda.empty_cache()
    if plain3:
        cfg3 = ILQRConfig(max_iterations=3, min_iterations=3)
        r_k = lanes.make_lane_phase_optimise(task, cfg3, Hh)(qp, qv, U0, tg)
        t0 = time.perf_counter()
        r_p = lanes.make_lane_phase_optimise(task, cfg3, Hh, plain=plain3)(
            qp, qv, U0, tg)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, b)) for a, b in zip(r_k, r_p))
        gap = float((r_k.cost_reduction - r_p.cost_reduction).abs().max())
        out.update(plain3_bitwise=same, plain3_max_abs_err=gap,
                   plain3_s=time.perf_counter() - t0,
                   plain3_twins="all" if plain3 is True else sorted(plain3))
        check(same, f"{name} {kp.name}: 3 iterations of the kernel path "
                    f"differ from the path with twins {plain3} by "
                    f"{gap:.3e}")
    return out


def main_adaptive(tasks):
    """The adaptive keypoint main paths of ADAPTIVE_MAIN: acrobot at H, B
    with the reference campaign's methods (3 iterations each also against
    twins), reaching at RH, RB with adaptive_jerk."""
    out = {}
    for model, name, min_N, max_N, twins in ADAPTIVE_MAIN:
        Hh, Bb = (H, B) if model == "acrobot" else (RH, RB)
        task = with_method(tasks[model], name, min_N, max_N)
        tag = f"{model} {method_tag(name, min_N, max_N)}"
        t0 = time.perf_counter()
        r = out[tag] = adaptive_path(task, Hh, Bb, twins)
        r["s"] = time.perf_counter() - t0
        print(f"main path {tag} H={Hh} B={Bb} x{ITERS} it: mean cost "
              f"reduction {r['mean_cost_reduction']:.6f}, "
              f"{r['solves_per_s']:.2f} solves/s, mean %derivs "
              f"{r['pct_derivs_mean']:.3f}, max overflow "
              f"{r['kp_overflow_max']}: {json.dumps(r)}", flush=True)
    return out


def clutter_check(plain):
    """The `clutter` phase: every push_lcl and push_ccl kernel against its
    twin at the check size (CH, CB) on clutter_inputs, bit for bit but K7
    (within TOL["backward"], its λ and λ-exit exactly): K3, K4, K5ad in its
    three slot modes, K6, K7 and fk_bias (check_kernels), K5 (check_fd), the
    twins from beside the build (`plain`), and K9a, K5ad at the plan's
    per-lane slots and K9b at the task's own method, AJ_1_100
    (check_plan, the twins here) -> rows by instance name."""
    rows = {}
    cfg = ILQRConfig()
    for name, level in CLUTTER.items():
        t1, inputs = check_case(name)
        pw = plain[name]
        r = rows[name] = check_kernels(t1, CH, CB, time_them=True,
                                       inputs=inputs, plain=pw, exact=True)
        q0, v0, _ = ops.rollout(t1, *inputs[:2], inputs[3], inputs[2])
        r["fd_jacobian"] = check_fd(t1, q0, v0, inputs[3],
                                    lanes.si_plan(t1, CH).times,
                                    plain=pw["fd_jacobian"])
        own = pushing.make_pushing(level, device="cuda")
        kc = own.keypoint_cfg
        label = f"{name} {method_tag(kc.name, kc.min_N, kc.max_N)}"
        ops.reset_launch_counts()
        kp = r["keypoints"] = check_plan(label, own, q0, v0, inputs[3],
                                         lanes.kp_budget(cfg, own, CH), cfg)
        kp["launches"] = {k: ops.LAUNCHES[k] for k in KP_TWINS}
        print(f"  keypoints {label} (H={CH}, B={CB}): {json.dumps(kp)}",
              flush=True)
    return rows


def clutter_adaptive(task):
    """`--deep`: push_lcl with its campaign method AJ_5_100 at UH, UB from
    its servos' start (3 iterations, adaptive_path)."""
    t0 = time.perf_counter()
    aj = with_method(si1(task), "adaptive_jerk", 5, 100)
    a = adaptive_path(aj, UH, UB, None, start=start_of(aj, UH, UB), iters=3)
    a["seconds"] = time.perf_counter() - t0
    print(f"main path push_lcl AJ_5_100 H={UH} B={UB} x3 it: "
          f"{json.dumps(a)}", flush=True)
    return a




def clutter_entries(crows, cmp, counts, runs):
    """The clutter tasks' entries of the `kernels` line: push_lcl's at its
    main path's shape (ms, bounds and launches of main_clutter's solve;
    errors and twins' ms from the clutter check), its K5, K9a and K9b
    launched by the CLI run (ms at the check), fk_bias from the main path's
    servo; push_ccl's at the check size, launched by its CLI run."""
    cli = {k: (runs[k][1] or {}).get("launches", {})
           for k in ("push_lcl", "push_ccl")}
    out = []
    for model, launches, ms, bounds, shape in (
            ("push_lcl", cmp["launches"], cmp["kernel_ms"], cmp["bounds"],
             f"H={UH} B={UB}"),
            ("push_ccl", cli["push_ccl"], None, None, None)):
        rows = crows[model]
        es = kernel_entries(model, rows, launches, counts[model], ms, bounds,
                            shape, f"H={CH} B={CB}")
        for e in es:
            e["bitwise"] = rows[e["name"]].get("bitwise")
            if e["name"] == "fd_jacobian":
                fd = rows["fd_jacobian"]
                e.update(launches=cli[model].get("fd_jacobian", 0),
                         launched_by="the CLI's Optimise_once (generic "
                         f"solve, B = 1, H = {CLI_CLUTTER_H}, AJ_1_100, "
                         "deriv_mode fd)", ms=fd["ms"],
                         bound_ms=fd["bound"][0], bound_by=fd["bound"][1],
                         shape=f"H={CH} B={CB}, SI_1 slots (check)")
            elif model == "push_ccl":
                e.update(shape=f"H={CH} B={CB} (check)",
                         launched_by="the CLI's Optimise_once (generic solve,"
                         f" B = 1, H = {CLI_CLUTTER_H}, AJ_1_100)"
                         if e["launches"] else "the clutter check alone")
        out += es
        kp = rows["keypoints"]
        for name in ("keypoint_plan", "kp_interp"):
            r = kp[name]
            out.append({
                "name": name, "model": model, "route": "cuda",
                "source": "trajoptkp_tpu_torch/kernels/csrc/"
                          f"{ops.SOURCES.get(name, name)}.cu",
                "replaces": ops.REPLACES[name],
                "launches": cli[model].get(name, 0),
                "launched_by": "the CLI's Optimise_once (generic solve, "
                               "B = 1, AJ_1_100)",
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "library_ms": None,
                "tolerance": "bit for bit", "bitwise": r["bitwise"],
                "shape": f"{kp['shape']}, AJ_1_100 on the check's nominal, "
                         f"K_max {kp['K_max']}, {kp['live_slots']} live "
                         "slots"})
    sc = cmp["servo_check"]
    fk, wide = sc["fk_bias"][0], crows["push_lcl"]["fk_bias"]
    out.append({
        "name": "fk_bias", "model": "push_lcl", "route": "cuda",
        "source": "trajoptkp_tpu_torch/kernels/csrc/rollout.cu",
        "device_function": "trajoptkp_tpu_torch/kernels/csrc/step.cuh",
        "replaces": "trajoptkp_tpu/tasks/pushing.py:421",
        "launches": cmp["servo"]["launches"].get("fk_bias", 0),
        "launched_by": f"the setup and init servo of the main path "
                       f"({pushing.SETUP_STEPS} + {UH} steps)",
        "max_abs_err": max(f["err"][0] for f in sc["fk_bias"] + [wide]),
        "ms": fk["ms"], "plain_ms": fk["plain_ms"],
        "bound_ms": fk["bound"][0], "bound_by": fk["bound"][1],
        "library_ms": None, "tolerance": fk["tol"],
        "shape": f"{fk['lanes']} lanes",
        "bitwise": all(f["bitwise"] for f in sc["fk_bias"] + [wide]),
        "servo_vs_plain_servo": {
            k: dict(steps=sc["steps"], max_abs_err=sc[k]["err"][0],
                    bitwise=sc[k]["bitwise"]) for k in ("setup", "init")}})
    return out


def flat(x):
    """The tensors of a (nested) tuple of phase outputs, in order."""
    if torch.is_tensor(x):
        return [x]
    return [t for y in x for t in flat(y)]


def same_values(a, b):
    """Equal element for element, NaN where the other is NaN (a lane whose
    λ loop ended invalid carries NaN gains in kernel and twin alike)."""
    return a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def outputs_gap(a, b):
    """(bit for bit, max abs err) of two phase outputs."""
    a, b = flat(a), flat(b)
    same = len(a) == len(b) and all(bool(torch.equal(x, y))
                                    for x, y in zip(a, b))
    gap = max((float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b) if x.numel()), default=0.0)
    return same, gap


def mpc_kernel_ms(task, qp, qv, U, tg, cfg, generic=False):
    """Per-phase device ms of one lane-last replan from (qp, qv, U) (each
    phase alone, 3 launches after a warm-up), the kernels' ms among them,
    and the first backward pass's sweeps; the cost expansion phase must
    launch K6 once.  The fourth value is the hold of that replan: a
    function that runs each kernel phase (K3, the Jacobians with their
    lerp, K6, K7, K4 with its argmin, K8 with noise drawn from seed 0)
    again as its plain twin on the same inputs and returns {kernel: (bit
    for bit, max abs err)}; the caller checks that they are equal bit for
    bit.  The Jacobians are K5ad's (the lane replan), or with `generic` the
    generic solve's (the async planner: K5 at the default deriv_mode)."""
    Hh, Bb = U.shape[0], U.shape[-1]
    jname = ("fd_jacobian" if generic and cfg.deriv_mode == "fd"
             else "ad_jacobian")
    ph = lanes.lane_phases(task, cfg, Hh, generic=generic)
    qpos, qvel, costs = ph["rollout"](qp, qv, U, tg)
    old = costs.sum(0)
    jac = ph["jacobians"](qpos, qvel, U)
    A, Bm = jac[:2]
    before = ops.LAUNCHES["cost_expansion"]
    l = ph["cost_expansion"](qpos, qvel, U, tg)
    check(ops.LAUNCHES["cost_expansion"] == before + 1,
          f"{task.name} replan's cost_expansion phase launched K6 "
          f"{ops.LAUNCHES['cost_expansion'] - before} times, not once")
    lam = torch.full((Bb,), cfg.lambda_init, dtype=torch.float64,
                     device="cuda")
    bp = ph["bp"](A, Bm, *l, lam)
    sweeps = bp_sweeps(ph["bp_info"])
    k, K, _, lam_out, _ = bp
    fp = ph["fp"](qpos, qvel, U, old, k, K, tg)
    traj, _, best, accept = fp
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    z = torch.randn((1, task.model.nu, Bb), generator=gen,
                    dtype=torch.float64, device="cuda")
    std = mpc_sync.noise_std(task, 5.0)
    apply = lambda plain=False: ops.mpc_apply(  # noqa: E731
        task, qp, qv, U, traj[2], accept, best, old, z, std, tg, plain=plain)
    applied = apply()

    def held():
        pp = lanes.lane_phases(task, cfg, Hh, plain=True, generic=generic)
        out = {
            "rollout": outputs_gap((qpos, qvel, costs),
                                   pp["rollout"](qp, qv, U, tg)),
            jname: outputs_gap(jac, pp["jacobians"](qpos, qvel, U)),
            "cost_expansion": outputs_gap(l, pp["cost_expansion"](
                qpos, qvel, U, tg)),
            "backward": outputs_gap(bp, pp["bp"](A, Bm, *l, lam)),
            "linesearch": outputs_gap(fp, pp["fp"](qpos, qvel, U, old, k, K,
                                                   tg)),
            "mpc_apply": outputs_gap(applied, apply(plain=True)),
        }
        torch.cuda.synchronize()
        return out

    plan = lanes.si_plan(task, Hh)
    with card_alone():
        phases = {
            "rollout": cuda_ms(lambda: ph["rollout"](qp, qv, U, tg), 3),
            "jacobians": cuda_ms(lambda: ph["jacobians"](qpos, qvel, U), 3),
            "cost_expansion": cuda_ms(lambda: ph["cost_expansion"](
                qpos, qvel, U, tg), 3),
            "bp": cuda_ms(lambda: ph["bp"](A, Bm, *l, lam), 3),
            "fp": cuda_ms(lambda: ph["fp"](qpos, qvel, U, old, k, K, tg), 3),
            "apply": cuda_ms(apply, 3),
        }
        kernel = {
            "rollout": phases["rollout"],
            "linesearch": cuda_ms(lambda: ops.linesearch(
                task, qpos, qvel, U, k, K, ph["alphas"], tg), 3),
            jname: cuda_ms(lambda: lanes.slot_jacobians(
                task, jname[:2], eps=cfg.fd_eps)(qpos, qvel, U, plan.times),
                3),
            "cost_expansion": phases["cost_expansion"],
            "backward": phases["bp"],
            "mpc_apply": phases["apply"],
        }
    return phases, kernel, sweeps, held


def mpc_plain_cases(walk, acro):
    """(task, H, num_apply, replans, B) of the kernel-vs-plain MPC holds
    (`mpc_holds`, in `--deep`): the walker's first replans of one episode
    and 6 acrobot replans."""
    return ((walk, MH, 1, MPC_PLAIN_REPLANS, 1), (si1(acro), 40, 2, 6, 4))


def mpc_run(t, Hh, na, n, Bb, plain):
    """(MPCRunResult, seconds) of n lane replans from the episode starts,
    noise from seed 0, on the kernels or (`plain`) on their twins."""
    qp, qv, tg = episode_starts(t, Bb)
    U0 = torch.zeros((Bb, Hh, t.model.nu), dtype=torch.float64,
                     device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    res = mpc_sync.make_lane_sync_mpc(t, ILQRConfig(), Hh, na, plain=plain)(
        qp, qv, U0, tg, n, gen)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def plain_mpc_runs(walk, acro):
    """The plain halves of the MPC holds (`mpc_holds`), {task name:
    (result, s)}, but the walker's (plain_mpc_worker): they launch no
    kernel, so they run while the kernels build."""
    return {t.name: mpc_run(t, Hh, na, n, Bb, True)
            for t, Hh, na, n, Bb in mpc_plain_cases(walk, acro)[1:]}


def plain_mpc_worker(path):
    """`--plain-mpc-worker PATH`: the walker's plain MPC hold (the first
    case of mpc_plain_cases, every kernel as its twin), saved to PATH.  It
    runs in a process of its own beside the build, so that its host-bound
    launches go in parallel with the other plain runs."""
    walk = make_walker(run=True, device="cuda")
    t, Hh, na, n, Bb = mpc_plain_cases(walk, make_acrobot(device="cuda"))[0]
    res, secs = mpc_run(t, Hh, na, n, Bb, True)
    torch.save({"result": tuple(x.cpu() for x in res), "seconds": secs},
               path)


def start_worker(flag, name, *args):
    """(process, path) of this script started now with `flag *args PATH` (a
    plain worker: plain_mpc_worker, check_worker)."""
    os.makedirs(MPC_OUT, exist_ok=True)
    path = os.path.join(MPC_OUT, name)
    if os.path.exists(path):
        os.remove(path)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             flag, *args, path], cwd=ROOT)
    BESIDE.append(proc)
    return proc, path


def finish_worker(worker, timeout=900):
    """What a worker process saved, once it has ended; it is stopped if it
    has not ended within `timeout` seconds."""
    proc, path = worker
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise RuntimeError(f"the plain worker {path} exited with code {rc}")
    return torch.load(path, weights_only=False)


def start_plain_mpc_worker():
    return start_worker("--plain-mpc-worker", "plain_walker_run.pt")


def finish_plain_mpc_worker(worker, timeout=900):
    """(result, s) of the walker's plain MPC hold from its worker process."""
    got = finish_worker(worker, timeout)
    return (mpc_sync.MPCRunResult(*(x.cuda() for x in got["result"])),
            got["seconds"])


def walker_hold_b128(task, cfg):
    """Each kernel phase of the walker's first replan of MB episodes against
    its twin, bit for bit (`--deep`) -> {phase: (bitwise, max abs err)}."""
    qp, qv, tg = (x.T.contiguous() for x in episode_starts(task, MB))
    U = torch.zeros((MH, task.model.nu, MB), dtype=torch.float64,
                    device="cuda")
    t0 = time.perf_counter()
    held = mpc_kernel_ms(task, qp, qv, U, tg, cfg)[3]()
    print(f"  walker_run first replan H={MH} B={MB}, each kernel phase vs "
          f"its twin (bitwise, max abs err): {json.dumps(held)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for k, (same, gap) in held.items():
        check(same, f"walker {k} at H={MH} B={MB} differs from its twin by "
                    f"{gap:.3e}")
    return {k: dict(bitwise=v[0], max_abs_err=v[1]) for k, v in held.items()}


def main_mpc(task, n_replans=N_REPLANS):
    """The walker MPC main path: walker_run SI_1 (the task's own keypoints)
    at its MPC horizon, one iteration and one applied control per replan,
    `n_replans` replans, through the campaign entry point
    (bench/campaigns.py:sync_mpc_horizon_sweep, mpc/sync.py's host-timed
    lane executor), with launch counts: one episode at H = MH (the main
    path), the sweep's other horizons, and MB episodes at MH.  Then the
    device ms of each phase inside one replan, each kernel phase of the
    replan of the MB episodes (the kernel path against the plain path,
    `mpc_holds`, and each kernel phase of the first replan of MB episodes
    against its twin, `walker_hold_b128`, run in `--deep`); the launches of
    both walker runs at MH are counted."""
    cfg = ILQRConfig()
    out = {}
    os.makedirs(MPC_OUT, exist_ok=True)
    ops.reset_launch_counts()
    # the replans' times are the card's alone: the twin workers wait
    with card_alone():
        row = sync_mpc_horizon_sweep(task, cfg, [MH], n_replans=n_replans,
                                     out_dir=os.path.join(MPC_OUT,
                                                          "b1_h40"))[0]
    launches = dict(ops.LAUNCHES)
    out["main"] = dict(row=row, launches=launches)
    for kname in LANE_KERNELS + ops.MPC_KERNELS:
        want = n_replans * bp_launches(kname, cfg)
        check(launches[kname] == want,
              f"walker MPC main path launched {kname} {launches[kname]} "
              f"times, not {want} ({n_replans} replans)")
    with card_alone():
        out["sweep"] = [row] + sync_mpc_horizon_sweep(
            task, cfg, [h for h in SWEEP if h != MH], n_replans=n_replans,
            out_dir=os.path.join(MPC_OUT, "sweep"))
        ops.reset_launch_counts()
        row_b = sync_mpc_horizon_sweep(
            task, cfg, [MH], n_replans=n_replans, B=MB,
            out_dir=os.path.join(MPC_OUT, "b128_h40"))[0]
    out["batched"] = dict(row=row_b, launches=dict(ops.LAUNCHES))
    for kname in LANE_KERNELS + ops.MPC_KERNELS:
        got = out["batched"]["launches"][kname]
        want = n_replans * bp_launches(kname, cfg)
        check(got == want,
              f"walker MPC at B={MB} launched {kname} {got} times, not "
              f"{want} ({n_replans} replans)")
    for r in out["sweep"] + [row_b]:
        check(all(math.isfinite(r[k]) for k in ("median_opt_time_ms",
                                                "p95_opt_time_ms",
                                                "mean_running_cost")),
              f"walker MPC H={r['horizon']} B={r['B']}: non-finite row {r}")
        print(f"  walker_run sync MPC H={r['horizon']} B={r['B']}: "
              f"{n_replans} replans, ms per replan median "
              f"{r['median_opt_time_ms']:.3f} p95 {r['p95_opt_time_ms']:.3f} "
              f"(mean {r['opt_time_ms']:.3f}), episode replans/s "
              f"{r['episode_replans_per_s']:.1f}, mean running cost "
              f"{r['mean_running_cost']:.6f}, launches per replan "
              f"{json.dumps(r['launches_per_replan'])}", flush=True)

    # device ms per phase inside one replan, from the episodes' start (at
    # MB episodes each kernel phase of that first replan is held against
    # its twin in `--deep`, walker_hold_b128)
    s = Sizes(task)
    for name, Bb in (("b1", 1), ("b128", MB)):
        qp, qv, tg = (x.T.contiguous() for x in episode_starts(task, Bb))
        U = torch.zeros((MH, task.model.nu, Bb), dtype=torch.float64,
                        device="cuda")
        phases, kms, sweeps, _ = mpc_kernel_ms(task, qp, qv, U, tg, cfg)
        out[f"phases_ms_{name}"] = phases
        out[f"kernel_ms_{name}"] = kms
        out[f"bounds_{name}"] = {
            "rollout": rollout_bound(s, MH, Bb),
            "linesearch": linesearch_bound(s, MH, 6, Bb),
            "ad_jacobian": ad_bound(s, MH, Bb),
            "backward": backward_bound(s.nx, s.nu, MH, Bb, sweeps),
            "mpc_apply": apply_bound(s, MH, 1, Bb),
            "cost_expansion": cost_expansion_bound(s, MH, Bb),
        }
        print(f"  walker_run one replan H={MH} B={Bb}: phases ms "
              f"{json.dumps({k: round(v, 4) for k, v in phases.items()})}, "
              f"bounds {json.dumps(out[f'bounds_{name}'])}", flush=True)

    return out


def mpc_holds(walk, acro, plain_runs):
    """The MPC kernel path against the plain path (`plain_runs`, run during
    the build), bit for bit, for each case of mpc_plain_cases whose plain
    run is given: the walker's first MPC_PLAIN_REPLANS replans of one
    episode, 6 acrobot replans."""
    out = {}
    for t, Hh, na, n, Bb in mpc_plain_cases(walk, acro):
        if t.name not in plain_runs:
            continue
        runs, secs = [], []
        for plain in (False, True):
            if plain:
                res, sec = plain_runs[t.name]
            else:
                res, sec = mpc_run(t, Hh, na, n, Bb, False)
            runs.append(res)
            secs.append(sec)
        same = all(bool(torch.equal(a, b)) for a, b in zip(*runs))
        gap = max(float((a - b).abs().max()) for a, b in zip(*runs))
        out[f"plain_{t.name}"] = dict(bitwise=same, max_abs_err=gap,
                                      replans=n, H=Hh, B=Bb, num_apply=na,
                                      kernel_s=secs[0], plain_s=secs[1])
        print(f"  {t.name} MPC kernel path vs plain path, {n} replans H={Hh}"
              f" B={Bb} num_apply {na}: bitwise equal {same}, max abs err "
              f"{gap:.3e} ({secs[0]:.2f} s vs {secs[1]:.2f} s)", flush=True)
        check(same, f"{t.name} MPC: the kernel path differs from the plain "
                    f"path by {gap:.3e}")
    return out


def async_hold(task, qpos0):
    """At the task's first state: one async planner step (`AsyncMPC.replan`,
    optimise at one iteration, horizon ASYNC_HOLD_H) against the same step
    with every kernel as its twin, and the actor's step (K3 at H = 1) and
    gravity hold (fk_bias) against their twins, each bit for bit."""
    runner = AsyncMPC(task, ILQRConfig(), ASYNC_HOLD_H)
    qv0 = task.qvel_start.cpu().numpy()
    U0 = np.zeros((ASYNC_HOLD_H, task.model.nu))
    t0 = time.perf_counter()
    k, _ = runner.replan(qpos0, qv0, U0)
    p, _ = runner.replan(qpos0, qv0, U0, plain=True)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    f64 = dict(dtype=torch.float64, device="cuda")
    qp = torch.as_tensor(qpos0, **f64)[:, None]
    qv = torch.as_tensor(qv0, **f64)[:, None]
    u = k.ctrl[0][:, None].contiguous()
    out = {"planner_step": outputs_gap(tuple(k), tuple(p)),
           "actor_step": outputs_gap(runner.step(qp, qv, u),
                                     runner.step(qp, qv, u, plain=True)),
           "gravity_hold": outputs_gap(runner.gravity_hold(qp, qv),
                                       runner.gravity_hold(qp, qv,
                                                           plain=True))}
    print(f"  {task.name} async, at the first state (bitwise, max abs err): "
          f"{json.dumps(out)}; planner step at H={ASYNC_HOLD_H} and its twin "
          f"{plan_s:.1f} s", flush=True)
    for name, (same, gap) in out.items():
        check(same, f"{task.name} async {name} differs from its twin by "
                    f"{gap:.3e}")
    return {k_: dict(bitwise=v[0], max_abs_err=v[1]) for k_, v in out.items()}


def async_summary(name, st, cost, dist, complete):
    """Print and check one real-time async episode's measurements: at least
    ASYNC_MIN_PLANS plans, a finite cost, and a planner that lowered its
    plan's cost in at least half of its replans."""
    print(f"  {name} async MPC (real time): {st['steps']} steps, "
          f"{st['replans']} replans, device ms per replan median "
          f"{st['median_replan_ms']:.3f} p95 {st['p95_replan_ms']:.3f} "
          f"({st['replan_rate_hz']:.2f} Hz; host ms mean "
          f"{st['mean_replan_host_ms']:.3f}), controls per plan "
          f"{st['controls_per_plan']}, plans improved by the planner's "
          f"iteration {st['improved_plans']}, gravity holds {st['holds']}, "
          f"ticker overruns {st['overruns']} (max lateness "
          f"{st['max_lateness_ms']:.3f} ms), episode cost {cost:.6g}, final "
          f"dist {dist}, complete {complete}", flush=True)
    check(st["replans"] >= ASYNC_MIN_PLANS,
          f"{name} async: the planner published {st['replans']} plans, "
          f"fewer than {ASYNC_MIN_PLANS}")
    check(math.isfinite(cost), f"{name} async: episode cost {cost}")
    check(2 * st["improved_plans"] >= st["replans"],
          f"{name} async: the planner's iteration lowered the plan's cost in "
          f"{st['improved_plans']} of {st['replans']} replans")


def async_launches(name, launches, steps, replans, holds):
    """Check the launches of real-time async episodes: the actor's K3 at
    every step and the planner's once per replan (K3 for its rollout, K5,
    K6, K7's first sweep and its retry rounds, K4; the planner's Jacobians
    are K5's at the generic solve's default deriv_mode "fd"), fk_bias once
    per gravity hold."""
    want = {"rollout": steps + replans, "fd_jacobian": replans,
            "ad_jacobian": 0, "cost_expansion": replans,
            "backward": replans * bp_launches("backward", ILQRConfig()),
            "linesearch": replans, "fk_bias": holds}
    for kname, n in want.items():
        check(launches[kname] == n,
              f"{name} async launched {kname} {launches[kname]} times, not "
              f"{n} ({steps} actor steps, {replans} replans, {holds} holds)")


def main_async(push, walk, n_scenes=ASYNC_PUSH_SCENES):
    """Asynchronous MPC on the card, float64, real time: push_ncl SI_1 over
    `n_scenes` scenes of the async campaign's generator, 500 steps
    each at 125 Hz, through `async_mpc_campaign`, and one walker_run
    episode of 2000 steps at 200 Hz as MPC_until_completion runs it, with
    exact launch counts (`async_launches`); first the holds of
    `async_hold` and the device ms of each phase of a push_ncl planner step
    at its own shape (H=50, B=1).  -> (record, hold): `hold` holds each
    kernel phase of that planner step against its twin, bit for bit (~40 s
    of host-bound twin launches, so main() runs it while the CLI processes
    run)."""
    cfg = ILQRConfig()
    push1 = si1(push)
    scenes = async_scenes(push1, n_scenes)
    out = {"hold_push_ncl": async_hold(push1, scenes[0]),
           "hold_walker": async_hold(walk, walk.qpos_start.cpu().numpy())}
    # device ms of each phase of one push_ncl planner step (B = 1) from the
    # first scene, as the walker's come from main_mpc (the async planner
    # does not apply: its "apply" is K8's, which the sync replan runs)
    f64 = dict(dtype=torch.float64, device="cuda")
    Hp = push.mpc_horizon
    qp0 = torch.as_tensor(scenes[0], **f64)[:, None]
    qv0 = push1.qvel_start[:, None].contiguous()
    U0 = torch.zeros((Hp, push.model.nu, 1), **f64)
    tg0 = push1.residual_targets[:, None].contiguous()
    phases, kms, _, hold = mpc_kernel_ms(push1, qp0, qv0, U0, tg0, cfg,
                                         generic=True)
    phases.pop("apply")
    out["phases_ms_push_ncl"] = phases
    # K5, the generic solve's Jacobians at deriv_mode "fd", at this shape:
    # its time, its twin's and its bound (its hold is in `hold`)
    q, v, _ = ops.rollout(push1, qp0, qv0, U0, tg0)
    times = lanes.si_plan(push1, Hp).times
    _, fd_plain_ms = cuda_timed(lambda: ops.fd_jacobian(
        push1, q, v, U0, times, cfg.fd_eps, plain=True))
    out["fd_jacobian_b1"] = dict(ms=kms["fd_jacobian"], plain_ms=fd_plain_ms,
                                 bound=fd_bound(Sizes(push1), Hp, 1),
                                 shape=f"H={Hp} B=1")
    print(f"  push_ncl async planner step H={Hp} B=1, phases "
          f"ms {json.dumps({k: round(v, 3) for k, v in phases.items()})}",
          flush=True)

    def hold_push():
        t0 = time.perf_counter()
        held = hold()
        out["held_push_ncl_b1"] = {k: dict(bitwise=v[0], max_abs_err=v[1])
                                   for k, v in held.items()}
        print(f"  push_ncl async planner step H={Hp} B=1, each kernel phase "
              f"vs its twin (bitwise, max abs err): {json.dumps(held)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        for k, (same, gap) in held.items():
            check(same, f"push_ncl {k} at H={Hp} B=1 differs from its twin "
                        f"by {gap:.3e}")

    ops.reset_launch_counts()
    try:
        rows = async_mpc_campaign(
            push1, cfg, scenes, Hp, max_steps=ASYNC_PUSH_STEPS,
            out_dir=os.path.join(MPC_OUT, "async_push"), realtime=True)
    except RuntimeError as e:
        check(False, f"push_ncl async campaign: {e!r} from {e.__cause__!r}")
        rows = []
    launches = dict(ops.LAUNCHES)
    out["push_ncl"] = dict(rows=rows, launches=launches)
    async_launches("push_ncl", launches, sum(r["steps"] for r in rows),
                   sum(r["replans"] for r in rows),
                   sum(r["holds"] for r in rows))
    for r in rows:
        async_summary(f"push_ncl trial {r['trial']}", r, r["episode_cost"],
                      r["final_dist"], r["task_complete"])
    # the pusher's distance to the object (the last residual) at each
    # scene's start and end: the object stays put within 500 steps (PERF.md
    # section 7)
    zeros = lambda n: torch.zeros((n, 1), **f64)  # noqa: E731
    reach = [(float(push1.residual_fn(
        torch.as_tensor(q, **f64)[:, None], zeros(push.model.nv),
        zeros(push.model.nu), push1.residual_targets[:, None])[-1, 0]),
        r["final_residuals"][-1]) for q, r in zip(scenes, rows)]
    out["push_ncl"]["reach_dist_start_end"] = reach
    disp = out["push_ncl"]["object_disp"] = [r["object_disp"] for r in rows]
    print(f"  push_ncl async launches ({len(rows)} trials): "
          f"{json.dumps(launches)}; pusher-to-object distance at each "
          f"trial's start and end {json.dumps(reach)}; the object's "
          f"horizontal displacement per scene (m) {json.dumps(disp)}",
          flush=True)

    H = walk.mpc_horizon
    ops.reset_launch_counts()
    runner = AsyncMPC(walk, cfg, H, realtime=True, seed=0)
    try:
        _, uh = runner.run(app.mpc_init_controls(walk, H),
                           max_steps=ASYNC_WALKER_STEPS)
    except RuntimeError as e:
        check(False, f"walker async: {e!r} from {e.__cause__!r}")
        uh = []
    launches = dict(ops.LAUNCHES)
    st = runner.stats()
    cost = runner.episode_cost()
    out["walker"] = dict(stats=st, launches=launches, episode_cost=cost,
                         task_complete=len(uh) < ASYNC_WALKER_STEPS)
    async_launches("walker_run", launches, st["steps"], st["replans"],
                   st["holds"])
    async_summary("walker_run", st, cost, 0.0, False)
    print(f"  walker_run async launches: {json.dumps(launches)}", flush=True)
    return out, hold_push


def k5_main_shapes(reach, walk):
    """K5 where the main paths run it besides the async push_ncl planner
    (main_async): the async walker planner's generic solve (SI_1 at H=MH,
    B=1, from the task's start under zero controls) and reaching's CLI
    Optimise_once (the generic solve at H=RH, B=1, velocity_change at
    per-lane slots on the same kind of nominal, its first iteration) ->
    {model: ms, the twin's ms, bound over the live slots, bit for bit}."""
    cfg = ILQRConfig()
    f64 = dict(dtype=torch.float64, device="cuda")
    out = {}
    for name, task, Hh in (("walker", walk, MH), ("reaching", reach, RH)):
        qp0, qv0, tg = (x[:, None].contiguous() for x in (
            task.qpos_start, task.qvel_start, task.residual_targets))
        U = torch.zeros((Hh, task.model.nu, 1), **f64)
        q, v, _ = ops.rollout(task, qp0, qv0, U, tg)
        if task.keypoint_cfg.name == "set_interval":
            times, counts = lanes.si_plan(task, Hh).times, None
            live = int(times.shape[0])
        else:
            plan = ops.keypoint_plan(ops.keypoint_plan_args(task), v, Hh, Hh)
            times, counts = plan.slot_t, plan.count
            live = int(plan.count.sum())

        def call(plain=False):
            return ops.fd_jacobian(task, q, v, U, times, cfg.fd_eps,
                                   counts=counts, plain=plain)
        same, gap = outputs_gap(call(), call(plain=True))
        check(same, f"{name} fd_jacobian at H={Hh} B=1 differs from its "
                    f"twin by {gap:.3e}")
        out[name] = dict(
            ms=cuda_ms(call, 5), plain_ms=cuda_timed(
                lambda: call(plain=True))[1],
            bound=fd_bound(Sizes(task), live, 1), live_slots=live,
            shape=f"H={Hh} B=1, {task.keypoint_cfg.name} slots, {live} "
                  "live", bitwise=same, max_abs_err=gap)
    print(f"  K5 at the walker's async planner and reaching's CLI solve: "
          f"{json.dumps(out)}", flush=True)
    return out


def report_main(name, Hh, Bb, mp):
    print(f"main path {name} SI_1 H={Hh} B={Bb} x{mp['iterations']} it: "
          f"mean cost "
          f"reduction {mp['mean_cost_reduction']:.4f}, {mp['solves_per_s']:.1f}"
          f" solves/s ({mp['wall_s']:.3f} s), phases ms "
          f"{json.dumps({k: round(v, 3) for k, v in mp['phases_ms'].items()})}"
          f", cost expansion bound {json.dumps(mp['cost_expansion_bound'])}"
          f", launches {json.dumps(mp['launches'])}, limit rows active in "
          f"{mp['limit_active_lane_steps']} lane-steps of the first rollout, "
          f"contacts {json.dumps(mp['contacts'])}"
          + (f", 3-it lanes agreeing with plain {mp['plain_agree_3it']:.4f} "
             f"({mp['plain_agree_shape']})" if "plain_agree_3it" in mp
             else ""), flush=True)


def cli_start(args):
    """Start one CLI run (python -m trajoptkp_tpu_torch.app ...)."""
    return subprocess.Popen(
        [sys.executable, "-m", "trajoptkp_tpu_torch.app", *args], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cli_finish(name, proc):
    """(its last line, parsed, and its whole output) of a CLI run started by
    cli_start; a failed run is a failed check."""
    try:
        out, errs = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, errs = proc.communicate()
    check(proc.returncode == 0, f"CLI {name} failed:\n{out}\n{errs}")
    if proc.returncode != 0:
        return None, None, out
    line = out.strip().splitlines()[-1]
    return line, json.loads(line), out


def cli_runs(beside=None):
    """The CLI on every task with its own keypoint method (acrobot and
    reaching velocity_change, push_ncl adaptive_jerk; reaching and push_ncl
    3 iterations), acrobot IE_1_50 and with `--deriv_mode ad` (K5ad in the
    generic solve), the walker's sync MPC campaign at one
    horizon and the two async modes, all started together (each a process
    of its own on the one card, so their times are taken side by side), and
    `beside()`, when given, run here while they run: {name: (last line,
    parsed, output)}."""
    runs = {
        "acrobot": ["--task", "acrobot", "--runMode", "Optimise_once"],
        "acrobot_ie": ["--task", "acrobot", "--runMode", "Optimise_once",
                       "--keypoint", "IE_1_50"],
        "acrobot_ad": ["--task", "acrobot", "--runMode", "Optimise_once",
                       "--deriv_mode", "ad"],
        "reaching": ["--task", "reaching", "--runMode", "Optimise_once",
                     "--maxIter", "3", "--minIter", "3"],
        "push": ["--task", "pushing_no_clutter", "--runMode",
                 "Optimise_once", "--maxIter", "3", "--minIter", "3"],
        # the box tasks at their own horizons and methods: box_sweep
        # AJ_1_1000 (K9a, K5 at per-lane slots, K9b) over 1500 steps,
        # threeD_push set_interval 1 over 1000
        "box_sweep": ["--task", "box_sweep", "--runMode", "Optimise_once",
                      "--maxIter", "3", "--minIter", "3"],
        "threeD_push": ["--task", "threeD_push", "--runMode",
                        "Optimise_once", "--maxIter", "3", "--minIter", "3"],
        # the clutter tasks at CLI_CLUTTER_H with their own method,
        # AJ_1_100
        "push_lcl": ["--task", "pushing_low_clutter", "--runMode",
                     "Optimise_once", "--horizon", str(CLI_CLUTTER_H),
                     "--maxIter", "3", "--minIter", "3"],
        "push_ccl": ["--task", "pushing_moderate_clutter_constrained",
                     "--runMode", "Optimise_once", "--horizon",
                     str(CLI_CLUTTER_H), "--maxIter", "3", "--minIter", "3"],
        "mpc": ["--task", "walker_run", "--runMode",
                "Generate_syncronus_mpc_data", "--horizon", str(MH),
                "--out_dir", os.path.join(MPC_OUT, "cli")],
        "async_push": ["--task", "pushing_no_clutter", "--runMode",
                       "Generate_asynchronus_mpc_data", "--num_scenes", "3",
                       "--keypoint", "SI_1", "--out_dir",
                       os.path.join(MPC_OUT, "cli_async")],
        "async_acrobot": ["--task", "acrobot", "--runMode",
                          "MPC_until_completion"],
    }
    procs = {k: cli_start(v) for k, v in runs.items()}
    try:
        if beside is not None:
            beside()
    except BaseException:
        for p in procs.values():
            p.kill()
            p.communicate()
        raise
    out = {k: cli_finish(k, p) for k, p in procs.items()}
    own = {"acrobot": "velocity_change", "acrobot_ie": "iterative_error",
           "acrobot_ad": "velocity_change",
           "reaching": "velocity_change", "push": "adaptive_jerk",
           "box_sweep": "adaptive_jerk", "threeD_push": "set_interval",
           "push_lcl": "adaptive_jerk", "push_ccl": "adaptive_jerk"}
    for k, method in own.items():
        res = out[k][1]
        if res is None:
            continue
        if k in ("box_sweep", "push_lcl", "push_ccl"):
            # box_sweep: from the task's own start the first backward pass
            # sends every λ to its cap, which ends the generic solve with
            # the initial controls (λ-exit): the JAX CLI's solve does the
            # same (tests/test_torch_box.py, H = 15; PERF.md §6); the
            # clutter runs are held to a finite cost that does not rise
            check(math.isfinite(res["final_cost"])
                  and 0.0 <= res["cost_reduction"] < 1.0
                  and res["keypoint_method"] == method
                  and res["iterations"] >= 1, f"CLI {k}: {res}")
            continue
        check(math.isfinite(res["cost_reduction"])
              and 0.0 < res["cost_reduction"] < 1.0
              and res["keypoint_method"] == method
              and 0.0 < res["mean_pct_derivs"] <= 100.0,
              f"CLI {k}: {res}")
    # Optimise_once is the generic solve: K5 at deriv_mode auto (fd), K5ad
    # at ad
    for k, jac in (("acrobot", "fd_jacobian"), ("acrobot_ad", "ad_jacobian"),
                   ("box_sweep", "fd_jacobian"),
                   ("threeD_push", "fd_jacobian"),
                   ("push_lcl", "fd_jacobian"), ("push_ccl", "fd_jacobian")):
        res = out[k][1]
        if res is not None:
            other = ({"fd_jacobian", "ad_jacobian"} - {jac}).pop()
            check(res["launches"].get(jac, 0) > 0
                  and other not in res["launches"]
                  and res["deriv_mode"] == ("ad" if k == "acrobot_ad"
                                            else "fd"),
                  f"CLI {k}: deriv_mode {res['deriv_mode']}, launches "
                  f"{res['launches']}")
    for k in ("box_sweep", "push_lcl", "push_ccl"):
        res = out[k][1]
        if res is not None:
            # AJ_1_1000 (box_sweep) and AJ_1_100 (the clutter tasks) on the
            # generic path: K9a's plan, K5 at per-lane slots, K9b's lerp;
            # the servo's fk_bias
            check(all(res["launches"].get(kn, 0) > 0 for kn in (
                "keypoint_plan", "kp_interp", "fd_jacobian", "fk_bias",
                "rollout", "cost_expansion", "backward")),
                  f"CLI {k}: launches {res['launches']}")
            if k != "box_sweep":
                check(res["horizon"] == CLI_CLUTTER_H, f"CLI {k}: {res}")
    if out["mpc"][1] is not None:
        (row,) = out["mpc"][1]["rows"]
        check(row["horizon"] == MH and row["timing"].startswith("cuda")
              and math.isfinite(row["median_opt_time_ms"])
              and math.isfinite(row["mean_running_cost"]),
              f"CLI walker_run MPC row {row}")
    res = out["async_push"][1]
    if res is not None:
        csv = os.path.join(res["campaign"], "async_mpc.csv")
        lines = open(csv).read().strip().splitlines() \
            if os.path.exists(csv) else []
        check(res["trials"] == 3 and len(lines) == 4
              and all(r["replans"] >= 1 and r["timing"].startswith("cuda")
                      for r in res["rows"]),
              f"CLI push_ncl async campaign: {res}, csv {lines}")
    res = out["async_acrobot"][1]
    if res is not None:
        check(res["task"] == "acrobot" and res["replans"] >= 1
              and 0 < res["steps"] <= app.ASYNC_MPC_STEPS
              and res["timing"].startswith("cuda"),
              f"CLI acrobot MPC_until_completion: {res}")
    return out


def box_entries(brows, bmp, counts, runs):
    """The box tasks' entries of the `kernels` line: box_sweep's at its main
    path's shape (ms, bounds and launches of that solve; errors from the box
    check, bit for bit), its K5 and fk_bias from the CLI run and the main
    path's servo, K9a and K9b at the main path's shape (box_keypoints),
    launched by the CLI run; threeD_push's at the check size, launched by
    its CLI run (its launches from that run's JSON line)."""
    out = kernel_entries("box_sweep", brows["box_sweep"], bmp["launches"],
                         counts["box_sweep"], bmp["kernel_ms"],
                         bmp["bounds"], f"H={BH} B={BB}", f"H={PH} B={PB}")
    cli = {k: (runs[k][1] or {}).get("launches", {})
           for k in ("box_sweep", "threeD_push")}
    for e in out:
        e["bitwise"] = brows["box_sweep"][e["name"]].get("bitwise")
        if e["name"] == "fd_jacobian":
            e.update(launches=cli["box_sweep"].get("fd_jacobian", 0),
                     launched_by="the CLI's Optimise_once (generic solve, "
                     "B = 1, deriv_mode fd; AJ_1_1000 at per-lane slots)",
                     ms=brows["box_sweep"]["fd_jacobian"]["ms"],
                     bound_ms=brows["box_sweep"]["fd_jacobian"]["bound"][0],
                     bound_by=brows["box_sweep"]["fd_jacobian"]["bound"][1],
                     shape=f"H={PH} B={PB}, SI_1 slots (check)")
    tdp = kernel_entries("threeD_push", brows["threeD_push"],
                         cli["threeD_push"], counts["threeD_push"])
    for e in tdp:
        e.update(bitwise=brows["threeD_push"][e["name"]].get("bitwise"),
                 shape=f"H={PH} B={PB} (check)",
                 launched_by="the CLI's Optimise_once (generic solve, B = 1,"
                 " H = 1000, set_interval 1, deriv_mode fd)"
                 if e["launches"] else "the box check alone (the CLI's "
                 "generic solve takes K5 at deriv_mode fd)")
    kp = bmp["keypoints"]
    for name in ("keypoint_plan", "kp_interp"):
        r = kp[name]
        out.append({
            "name": name, "model": "box_sweep", "route": "cuda",
            "source": "trajoptkp_tpu_torch/kernels/csrc/"
                      f"{ops.SOURCES.get(name, name)}.cu",
            "replaces": ops.REPLACES[name],
            "launches": cli["box_sweep"].get(name, 0),
            "launched_by": "the CLI's Optimise_once (generic solve, B = 1, "
                           "AJ_1_1000)",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None,
            "tolerance": "bit for bit", "bitwise": r["bitwise"],
            "shape": f"{kp['shape']}, AJ_1_1000 on the main path's initial "
                     f"nominal, K_max {kp['K_max']}, {kp['live_slots']} live "
                     "slots"})
    sc = bmp["servo_check"]
    fk, wide = sc["fk_bias"][0], brows["box_sweep"]["fk_bias"]
    out.append({
        "name": "fk_bias", "model": "box_sweep", "route": "cuda",
        "source": "trajoptkp_tpu_torch/kernels/csrc/rollout.cu",
        "device_function": "trajoptkp_tpu_torch/kernels/csrc/step.cuh",
        "replaces": "trajoptkp_tpu/tasks/pushing.py:421",
        "launches": bmp["servo"]["launches"].get("fk_bias", 0),
        "launched_by": f"the init servo of the main path ({BH} steps)",
        "max_abs_err": max(f["err"][0] for f in sc["fk_bias"] + [wide]),
        "ms": fk["ms"], "plain_ms": fk["plain_ms"],
        "bound_ms": fk["bound"][0], "bound_by": fk["bound"][1],
        "library_ms": None, "tolerance": fk["tol"],
        "shape": f"{fk['lanes']} lanes",
        "bitwise": all(f["bitwise"] for f in sc["fk_bias"] + [wide]),
        "servo_vs_plain_servo": dict(steps=sc["steps"],
                                     max_abs_err=sc["init"]["err"][0],
                                     bitwise=sc["init"]["bitwise"])})
    return out + tdp


def kernel_entries(model_name, rows, launches, step_counts, ms=None,
                   bounds=None, shape=None, check_shape=None, full=None):
    """Entries of the `kernels` line for one model.  `ms` and `bounds`, when
    given, are taken at the main path's shape `shape`; the error and the
    plain twin's time then come from the smaller check at `check_shape`,
    and `full` holds the errors against the twins at `shape` itself
    (`stepwise_check`); the larger of the two errors is reported.
    `step_counts` holds the double operations per step of the device
    functions inside the rollout, line-search and Jacobian kernels."""
    out = []
    for name in [k for k in ops.KERNELS + ops.MPC_KERNELS if k in rows]:
        r = rows[name]
        b = bounds.get(name, r["bound"]) if bounds else r["bound"]
        e = {
            "name": name, "model": model_name, "route": "cuda",
            "source": f"trajoptkp_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": ops.REPLACES[name],
            "launches": launches.get(name, 0),
            "max_abs_err": r["err"][0],
            "ms": ms.get(name, r["ms"]) if ms else r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None,
            "tolerance": r["tol"],
        }
        if shape:
            e.update(shape=shape, plain_shape=check_shape,
                     max_abs_err_at_plain_shape=r["err"][0],
                     ms_at_plain_shape=r["ms"],
                     bound_ms_at_plain_shape=r["bound"][0])
            if full:
                e["max_abs_err"] = max(r["err"][0], full[name][0])
        if name == "cost_expansion":
            e["bitwise"] = r["bitwise"] and (
                full is None or full["cost_expansion_bitwise"])
            e["library_ms_note"] = ("no single PyTorch call computes a "
                                    "residual Jacobian and its Gauss-Newton "
                                    "products")
            if step_counts.get("fk"):
                e["device_functions"] = [{
                    "name": "step (FK only: fk_frames)",
                    "source": ops.DEVICE_FUNCTIONS["step"][0],
                    "replaces": ops.DEVICE_FUNCTIONS["step"][1],
                    "ops_per_call": step_counts["fk"]}]
        elif name != "backward":
            # the step's device functions this model instantiates (held
            # against their twins through this kernel's check); K2c's
            # implicit tangent runs in K5ad's dual step alone
            e["device_functions"] = [
                {"name": k, "source": v[0], "replaces": v[1],
                 ("ops_per_slot_lane" if k == "implicit_tangent"
                  else "ops_per_step"): step_counts[k]}
                for k, v in ops.DEVICE_FUNCTIONS.items()
                if step_counts[k] > 0 and (k != "implicit_tangent"
                                           or name == "ad_jacobian")]
        if name == "ad_jacobian":
            e["bitwise"] = r["bitwise"] and (
                full is None or full["ad_bitwise"])
            e["modes"] = r["modes"]
            e["ops_per_slot_lane"] = step_counts["ad_slot"]
        out.append(e)
    return out


def instance_of(model_name, kernel):
    """The instance tables behind a `kernels` entry (push_ccl shares
    push_lcl's; K5 reads the step-only instance, build.step_shared)."""
    tag = "push_lcl" if model_name == "push_ccl" else model_name
    if kernel == "fd_jacobian":
        tag = build.step_shared()[tag]
    return build.instance_tables()[tag]


def k35_routes(kernels):
    """K3's and K5's source and launch plan in their `kernels` entries, at
    the shape each entry reports (acrobot's main path where it names
    none): K3 with constraint rows is the line search's warp kernel in its
    open loop (csrc/linesearch.cu), a warp per scene; K5 a warp per (slot,
    column, scene) item; without rows a thread per scene or item."""
    for e in kernels:
        if e["name"] not in ("rollout", "fd_jacobian"):
            continue
        topo = instance_of(e["model"], e["name"])
        m = re.search(r"H=(\d+) B=(\d+)", e.get("shape", ""))
        Hh, Bb = (int(m.group(1)), int(m.group(2))) if m else (H, B)
        csrc = "trajoptkp_tpu_torch/kernels/csrc/"
        if e["name"] == "rollout":
            g = ops.linesearch_geometry(topo, 1, Bb)
            e["source"] = csrc + ("linesearch.cu" if g.warp else
                                  "rollout.cu")
            e["geometry"] = dict(g._asdict(), kernel=(
                "linesearch_warp_kernel in its open loop (null gains, "
                "A = 1): a warp per scene" if g.warp else
                "rollout_kernel: a thread per scene"))
        else:
            g = ops.fd_geometry(topo, Hh, Bb)
            e["geometry"] = dict(
                g._asdict(), items=Hh * (2 * topo.NDOF + topo.NU) * Bb,
                kernel=("fd_warp_kernel: a warp per (slot, column, scene)"
                        if g.warp else "fd_thread_kernel: a thread per "
                        "(slot, column, scene)"))
        if g.warp:
            e["device_step"] = csrc + "warp_step.cuh"


def k35_summary(record, mp, rmp, ump, bmp, cmp, wmp):
    """K3 and K5 per launch on each main path (the main paths' rollout
    phase; the walker's replan at B=1 and 128; the async push_ncl planner's
    rollout and jacobians phases and K5 at its shape) -> dict."""
    out = {f"rollout {name} H={Hh} B={Bb}": m["phases_ms"]["rollout"]
           for name, m, Hh, Bb in (
               ("acrobot", mp, H, B), ("reaching", rmp, RH, RB),
               ("push_ncl", ump, UH, UB), ("box_sweep", bmp, BH, BB),
               ("push_lcl", cmp, UH, UB)) if m}
    if wmp:
        out[f"rollout walker H={MH} B=1"] = wmp["kernel_ms_b1"]["rollout"]
        out[f"rollout walker H={MH} B={MB}"] = wmp["kernel_ms_b128"][
            "rollout"]
        out[f"walker replan H={MH} B=1 median"] = wmp["main"]["row"][
            "median_opt_time_ms"]
    ma = record.get("main_async")
    if ma:
        ph = ma["phases_ms_push_ncl"]
        out["async push_ncl planner rollout phase H=50 B=1"] = ph["rollout"]
        out["async push_ncl planner jacobians phase H=50 B=1"] = ph[
            "jacobians"]
        out["fd_jacobian push_ncl H=50 B=1"] = ma["fd_jacobian_b1"]["ms"]
    return out


def keypoint_entries(kps, amp):
    """Entries of the `kernels` line for K9a, K9b and K9c: acrobot's and
    reaching's from their adaptive main paths (ms and launches of that
    solve, the twin's time and the bound at its first nominal; ie_mse from
    acrobot IE_1_50, timed per launch over the bisection tree's levels at
    the check size), the error from the keypoints phase; pentabot's, push_ncl's and the
    walker's from the keypoints phase (launched there, at the check size;
    push_ncl's at its full shape)."""
    out = []
    src = "trajoptkp_tpu_torch/kernels/csrc/{}.cu"

    def entry(name, model, launches, ms, plain_ms, bnd, err, same, shape,
              **extra):
        return {"name": name, "model": model, "route": "cuda",
                "source": src.format(ops.SOURCES.get(name, name)),
                "replaces": ops.REPLACES[name], "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                "tolerance": "bit for bit", "bitwise": same, "shape": shape,
                **extra}

    for model, tag, check_tag in (("acrobot", "acrobot AJ_1_50",
                                   "acrobot AJ_1_50"),
                                  ("reaching", "reaching AJ_5_100",
                                   "reaching AJ_5_100")):
        a = amp[tag]
        for name in ("keypoint_plan", "kp_interp"):
            c = kps[check_tag][name]
            full = kps.get(f"{model} AJ_5_100 full shape", {}).get(name)
            err = max([c["max_abs_err"]] + ([full["max_abs_err"]] if full
                                            else []))
            same = c["bitwise"] and (full is None or full["bitwise"])
            out.append(entry(
                name, model, a["launches"].get(name, 0), a["kernel_ms"][name],
                a["plain_ms"][name], a["bounds"][name], err, same,
                f"{'H=500 B=512' if model == 'acrobot' else 'H=1500 B=128'}, "
                f"{tag.split()[1]} main path",
                max_abs_err_shape=kps[check_tag]["shape"],
                full_shape_check=full and {k: full[k] for k in (
                    "bitwise", "max_abs_err", "plain_ms", "ms")},
                other_methods={t: {"ms": r["kernel_ms"][name],
                                   "launches": r["launches"].get(name, 0)}
                               for t, r in amp.items() if t.startswith(model)
                               and "kernel_ms" in r and t != tag}))
    ie = amp["acrobot IE_1_50"]
    c = kps["acrobot IE_1_50"]
    out.append(entry(
        "ie_mse", "acrobot", ie["launches"].get("ie_mse", 0), c["ie_mse"]["ms"]
        / c["ie_mse"]["launches_timed"], c["ie_mse"]["plain_ms"]
        / c["ie_mse"]["launches_timed"], c["ie_mse"]["bound"],
        c["ie_mse"]["max_abs_err"], c["ie_mse"]["bitwise"],
        f"H={PH} B={PB}, mean over the bisection tree's "
        f"{c['ie_mse']['levels']} levels ({c['ie_mse']['nodes']} nodes)",
        ms_note="per launch at the check size; the IE_1_50 main path "
        f"launches it {ie['launches'].get('ie_mse', 0)} times at H={H} B={B}",
        phase_check=c["phase"]))
    for model, tag in (("pentabot", "pentabot AA_1_10"),
                       ("push_ncl", "push_ncl AJ_5_100"),
                       ("walker", "walker VC_1_20")):
        c = kps[tag]
        for name in ("keypoint_plan", "kp_interp"):
            r = c[name]
            out.append(entry(
                name, model, c["launches"][name], r["ms"], r["plain_ms"],
                r["bound"], r["max_abs_err"], r["bitwise"], c["shape"],
                launched_by="the keypoints phase (this model runs no "
                            "adaptive main path)"))
    return out


def build_beside(beside=None, worker=None, lazy=False):
    """Build every kernel library (with `lazy`, build.LAZY's too) in a
    thread while `beside()` runs the plain halves that launch no kernel,
    and wait for the plain MPC worker process `worker` (stopped if it has
    not ended) -> (build seconds, nvcc logs, beside()'s result, the
    worker's result)."""
    built = {}
    build_thread = threading.Thread(
        target=lambda: built.update(out=build.build_all_timed(lazy)))
    plain = worked = None
    try:
        build_thread.start()
        if beside is not None:
            plain = beside()
        build_thread.join()
        if worker is not None:
            t0 = time.perf_counter()
            worked = finish_plain_mpc_worker(worker)
            print(f"plain walker MPC run in its own process: "
                  f"{worked[1]:.1f} s (waited "
                  f"{time.perf_counter() - t0:.1f} s after the build)",
                  flush=True)
    finally:
        if worker is not None and worker[0].poll() is None:
            worker[0].kill()
            worker[0].wait()
    if "out" not in built:
        raise RuntimeError("the kernel build failed (its error is above)")
    build_s, logs = built["out"]
    print(f"kernel build: {build_s:.1f} s ({len(build.libraries(lazy))} "
          "nvcc in parallel, one per library and instance)", flush=True)
    for name, text in logs.items():
        for ln in text.splitlines():
            if ("registers" in ln or "spill" in ln or "Compiling" in ln
                    or "warning" in ln or "done after" in ln):
                print(f"  ptxas {name}: {ln.strip()}", flush=True)
    return build_s, logs, plain, worked


def nvcc_table(logs):
    """Per library of the build logs: the seconds until its nvcc was done
    (the compilers run side by side), and the largest registers, stack
    frame and spill stores ptxas reported for its kernels."""
    out = {}
    for name, text in logs.items():
        row = dict(s=None, registers=0, stack=0, spill_stores=0)
        for ln in text.splitlines():
            m = re.search(r"done after ([0-9.]+) s", ln)
            if m:
                row["s"] = float(m.group(1))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                row["registers"] = max(row["registers"], int(m.group(1)))
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                          ln)
            if m:
                row["stack"] = max(row["stack"], int(m.group(1)))
                row["spill_stores"] = max(row["spill_stores"],
                                          int(m.group(2)))
        out[name] = row
    return out


# the jobs of `--deep` (its --phases), in the order they run
DEEP_PHASES = ("main_paths", "full_shapes", "clutter_full_shape",
               "keypoints", "mpc", "async")


def deep(card, phases):
    """`--deep`: the deep agreement holds and the full depths, a job of
    their own (the default run keeps every kernel against its twin at every
    model and every main path), in the `phases` of DEEP_PHASES:

    - main_paths: the acrobot, reaching, push_ncl, box_sweep and push_lcl
      main paths at ITERS iterations, with 3 iterations of the kernel path
      against the plain path (acrobot H=500 B=512, reaching H=RH3,
      push_ncl H=UH3 and push_lcl H=CH3 at B=PB; box_sweep's 3 iterations
      run in the default job);
    - full_shapes: reaching's, push_ncl's and box_sweep's kernels against
      their twins at their main paths' shapes (full_shape);
    - clutter_full_shape: push_lcl's, over its first CLUTTER_STEPS steps
      and slots but K6, K7 and fk_bias whole;
    - keypoints: the keypoint kernels at reaching's and push_ncl's full
      shapes, push_lcl AJ_5_100, acrobot VC_1_200's 3 iterations against
      the whole plain path;
    - mpc: the walker's sync MPC sweep at DEEP_REPLANS replans (main_mpc),
      its first MPC_PLAIN_REPLANS replans and 6 acrobot replans against
      the plain path, and each kernel phase of the walker's first replan
      of MB episodes against its twin;
    - async: main_async over DEEP_PUSH_SCENES scenes, with its hold of the
      push_ncl planner step.

    The build compiles the libraries the default run leaves to their first
    launch too (build.LAZY).  The plain halves of acrobot's and reaching's
    3-iteration solves and of the MPC holds run beside the build, the
    walker's in a process of its own.  Prints a `record` line and no result
    line; exits 1 if a check failed."""
    t_start = time.perf_counter()
    acro = make_acrobot(device="cuda")
    reach = make_reaching(device="cuda")
    push = pushing.make_pushing(device="cuda")
    walk = make_walker(run=True, device="cuda")
    box = manipulation.make_box_sweep(device="cuda")
    lcl = pushing.make_pushing(3, device="cuda")

    def beside():
        runs = plain_mpc_runs(walk, acro) if "mpc" in phases else {}
        plain3 = {}
        for task, Hh, Bb, H3 in ((acro, H, B, H), (reach, RH, RB, RH3)):
            if "main_paths" not in phases:
                break
            plain3[task.name] = plain_3it(task, Hh, Bb, H3)
            print(f"plain 3-iteration {task.name} solve beside the build: "
                  f"{plain3[task.name][1]:.1f} s", flush=True)
        return runs, plain3

    build_s, logs, (runs, plain3), worked = build_beside(
        beside, start_plain_mpc_worker() if "mpc" in phases else None,
        lazy=True)
    if "mpc" in phases:
        runs[walk.name] = worked
    record = {"card": card, "build_s": build_s, "nvcc": nvcc_table(logs),
              "deep": {}}
    rec = record["deep"]

    def timed(key, fn):
        t0 = time.perf_counter()
        r = rec[key] = fn()
        r["seconds"] = time.perf_counter() - t0
        return r

    if "main_paths" in phases:
        for task, Hh, Bb, H3 in ((acro, H, B, H), (reach, RH, RB, RH3),
                                 (push, UH, UB, UH3), (box, BH, BB, None),
                                 (lcl, UH, UB, CH3)):
            m = timed(task.name, lambda: main_path(
                task, Hh, Bb, H3, task is not acro,
                0 if task is lcl else 1, plain3=plain3.get(task.name)))
            report_main(task.name, Hh, Bb, m)
    for phase, task, Hh, Bb in (("full_shapes", reach, RH, RB),
                                ("full_shapes", push, UH, UB),
                                ("full_shapes", box, BH, BB),
                                ("clutter_full_shape", lcl, UH, UB)):
        if phase in phases:
            timed(f"{task.name} full shape",
                  lambda: full_shape(task, Hh, Bb))
    if "keypoints" in phases:
        rec["keypoints_full_shapes"] = keypoints_full_shapes(
            {"reaching": reach, "push_ncl": push})
        rec["push_lcl AJ_5_100"] = clutter_adaptive(lcl)
        vc = with_method(acro, "velocity_change", 1, 200)
        timed("acrobot VC_1_200", lambda: adaptive_path(vc, H, B, True))
    if "mpc" in phases:
        timed("main_mpc", lambda: main_mpc(walk, DEEP_REPLANS))
        timed("mpc", lambda: dict(mpc_holds(walk, acro, runs),
                                  held_b128=walker_hold_b128(
                                      walk, ILQRConfig())))
    if "async" in phases:
        t0 = time.perf_counter()
        rec["main_async"], hold_push = main_async(push, walk,
                                                  DEEP_PUSH_SCENES)
        hold_push()
        rec["main_async"]["seconds"] = time.perf_counter() - t0
    record["seconds"] = time.perf_counter() - t_start
    print(f"chip_smoke --deep: {record['seconds']:.1f} s in all (nvcc "
          f"{build_s:.1f} s)", flush=True)
    print("record " + json.dumps(record), flush=True)
    if FAILED:
        raise RuntimeError(f"{len(FAILED)} checks failed: {FAILED}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", help="a subset of PHASES (with --deep, of "
                    "DEEP_PHASES); all by default")
    ap.add_argument("--deep", action="store_true",
                    help="the deep agreement holds alone (see `deep`)")
    ap.add_argument("--plain-mpc-worker", metavar="PATH",
                    help=argparse.SUPPRESS)
    ap.add_argument("--plain-check-worker", nargs=2,
                    metavar=("NAMES", "PATH"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    known = DEEP_PHASES if args.deep else PHASES
    phases = args.phases.split(",") if args.phases else list(known)
    unknown = [p for p in phases if p not in known]
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; known: {known}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    if args.plain_mpc_worker:
        plain_mpc_worker(args.plain_mpc_worker)
        return
    if args.plain_check_worker:
        check_worker(*args.plain_check_worker)
        return
    if args.deep:
        card = card_line()
        print(f"card: {card}", flush=True)
        deep(card, phases)
        return
    t_start = time.perf_counter()
    phase_s = {}
    t_phase = [t_start]

    def done(phase):
        now = time.perf_counter()
        phase_s[phase] = now - t_phase[0]
        t_phase[0] = now
        print(f"phase {phase}: {phase_s[phase]:.1f} s", flush=True)

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    acro = make_acrobot(device="cuda")
    penta = make_pentabot(device="cuda")
    reach = make_reaching(device="cuda")
    push = pushing.make_pushing(device="cuda")
    walk = make_walker(run=True, device="cuda")
    box = manipulation.make_box_sweep(device="cuda")
    tdp = manipulation.make_threed_push(device="cuda")
    lcl = pushing.make_pushing(3, device="cuda")

    # the kernels build while the plain halves of the gated checks run in
    # processes of their own: host-bound twin launches that need no kernel
    workers = [start_worker("--plain-check-worker", f"plain_{i}.pt", names)
               for i, names in enumerate(CHECK_WORKERS)]
    try:
        build_s, logs, _, _ = build_beside()
        plain = {}
        t0 = time.perf_counter()
        for w in workers:
            plain.update(_to(finish_worker(w), "cuda"))
        print(f"plain halves of the checks in {len(workers)} processes of "
              f"their own: waited {time.perf_counter() - t0:.1f} s after the "
              "build", flush=True)
    finally:
        for w in workers:
            if w[0].poll() is None:
                w[0].kill()
                w[0].wait()
    t0 = time.perf_counter()
    native_executor.build()
    print(f"native executor build (g++): {time.perf_counter() - t0:.1f} s",
          flush=True)
    done("build")

    record = {"card": card, "build_s": build_s, "phase_s": phase_s,
              "nvcc": nvcc_table(logs)}
    if "bp_instances" in phases:
        record["bp_instances"] = bp_instances(logs)
        done("bp_instances")
    if "step_instances" in phases:
        record["step_instances"] = step_instances(
            logs, plain.get("step_instances"))
        done("step_instances")
    rows = prow = rrow = urow = wrow = None
    if "acrobot" in phases:
        rows = check_kernels(acro, H, B, time_them=True)
        # K5 (central FD) at the main path's shape and SI_1 slots, on the
        # zero-control nominal; the generic solve (the CLI) launches it
        qp0, qv0, tg = lane_inputs(acro, H, B, seed=3)[:3]
        U0 = torch.zeros((H, acro.model.nu, B), dtype=torch.float64,
                         device="cuda")
        q0, v0, _ = ops.rollout(acro, qp0, qv0, U0, tg)
        rows["fd_jacobian"] = check_fd(acro, q0, v0, U0,
                                       lanes.si_plan(si1(acro), H).times)
        done("acrobot")
    if "pentabot" in phases:
        prow = check_kernels(penta, PH, PB, time_them=False,
                             inputs=check_case("pentabot")[1],
                             pair_types=True, plain=plain["pentabot"])
        record["pentabot"] = {k: prow[k]["err"] for k in LANE_KERNELS}
        done("pentabot")
    if "reaching" in phases:
        rrow = check_kernels(reach, PH, PB, time_them=True,
                             at_limits=True, inputs=check_case("reaching")[1],
                             plain=plain["reaching"])
        record["reaching_check"] = {
            k: {kk: vv for kk, vv in v.items() if kk != "bound"}
            for k, v in rrow.items()}
        done("reaching")
    push_worker = None
    if "push" in phases:
        # the check's inputs start from the kernel servo: its twins run in
        # a process of their own beside the later phases (check_worker),
        # and the check itself before the CLI phase
        torch.save(_to(push_inputs(si1(push), PH, PB, seed=3), "cpu"),
                   PUSH_INPUTS)
        push_worker = start_worker("--plain-check-worker", "plain_push.pt",
                                   "push_ncl")
        done("push")
    if "walker" in phases:
        inputs = check_case("walker")[1]
        wrow = check_kernels(walk, WH, WB, time_them=True, inputs=inputs,
                             pair_types=True, plain=plain["walker"])
        wrow["mpc_apply"] = check_apply(walk, *inputs[:4], seed=4)
        record["walker_check"] = {
            k: {kk: vv for kk, vv in v.items() if kk != "bound"}
            for k, v in wrow.items()}
        done("walker")
    brows = {}
    if "box" in phases:
        # box_inputs: the box flat, tilted and pressed in, the pusher
        # touching it, inside it and pressed into the table, every pair
        # active; K5 (central FD) too, the CLI's generic solve's
        for task in (box, tdp):
            t1, inputs = check_case(task.name)
            pw = plain[task.name]
            r = brows[task.name] = check_kernels(
                t1, PH, PB, time_them=True, inputs=inputs, plain=pw,
                exact=True)
            q0, v0, _ = ops.rollout(t1, *inputs[:2], inputs[3], inputs[2])
            r["fd_jacobian"] = check_fd(t1, q0, v0, inputs[3],
                                        lanes.si_plan(t1, PH).times,
                                        plain=pw["fd_jacobian"])
        record["box_check"] = {
            t: {k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                for k, v in r.items()} for t, r in brows.items()}
        done("box")
    crows = {}
    if "clutter" in phases:
        crows = clutter_check(plain)
        record["clutter_check"] = {
            t: {k: ({kk: vv for kk, vv in v.items() if kk != "bound"}
                    if isinstance(v, dict) else v) for k, v in r.items()}
            for t, r in crows.items()}
        done("clutter")
    for name in ops.KERNELS + ops.MPC_KERNELS:
        for model, r in (("acrobot", rows), ("pentabot", prow),
                         ("reaching", rrow), ("push_ncl", urow),
                         ("walker", wrow),
                         ("box_sweep", brows.get("box_sweep")),
                         ("threeD_push", brows.get("threeD_push")),
                         ("push_lcl", crows.get("push_lcl")),
                         ("push_ccl", crows.get("push_ccl"))):
            if r and name not in r:
                continue
            if r:
                print(f"check {name}: {model} {r[name]['tol']} err "
                      f"{r[name]['err'][1]:.3e}", flush=True)

    kps = None
    if "keypoints" in phases:
        kp_inputs = {
            "acrobot": lane_inputs(acro, PH, PB, seed=3),
            "pentabot": pentabot_inputs(penta, PH, PB, seed=3),
            "reaching": lane_inputs(reach, PH, PB, seed=3, at_limits=True),
            "push_ncl": push_inputs(si1(push), PH, PB, seed=3),
            "walker": walker_inputs(walk, WH, WB, seed=3),
        }
        kps = record["keypoints"] = keypoints_phase(
            {"acrobot": acro, "pentabot": penta, "reaching": reach,
             "push_ncl": push, "walker": walk}, kp_inputs)
        del kp_inputs
        done("keypoints")

    if "golden" in phases:
        gold = record["golden"] = golden_replay()
        print(f"golden replay (kernel path): ctrl {gold['ctrl']:.2e} qpos "
              f"{gold['qpos']:.2e} final cost {gold['final_cost']:.2e}",
              flush=True)
        done("golden")

    mp = rmp = ump = None
    if "main_acrobot" in phases:
        mp = record["main_path"] = main_path(acro, H, B, None, False)
        report_main("acrobot", H, B, mp)
        done("main_acrobot")
    bmp = cmp = None
    for phase, task, Hh, Bb, H3, key in (
            ("main_reaching", reach, RH, RB, None, "main_path_reaching"),
            ("main_push", push, UH, UB, None, "main_path_push"),
            ("main_box_sweep", box, BH, BB, BH3, "main_path_box_sweep"),
            ("main_clutter", lcl, UH, UB, None, "main_path_clutter")):
        if phase not in phases:
            continue
        # reaching's and push_ncl's warm-up is one iteration, box_sweep's
        # and push_lcl's none (their libraries ran in the box and clutter
        # phases, and a push_lcl iteration takes ~34 s): their kernels ran
        # in the checks
        plain3 = None
        if task is box:
            r, secs, U3 = plain["box_sweep_3it"]
            plain3 = (lanes.LaneBatchResult(*r), secs, U3)
        # the full-shape holds (full_shape) run in `--deep`
        m = record[key] = main_path(task, Hh, Bb, H3, True,
                                    0 if task in (box, lcl) else 1,
                                    plain3=plain3,
                                    iters=MAIN_ITERS.get(task.name, ITERS))
        report_main(task.name, Hh, Bb, m)
        print(f"  {task.name} kernels at H={Hh} B={Bb}: ms "
              f"{json.dumps({k: round(v, 3) for k, v in m['kernel_ms'].items()})}"
              f", bounds {json.dumps(m['bounds'])}, first backward pass "
              f"{m['bp_sweeps_first']:.2f} sweeps per lane, peak memory "
              f"{m['peak_memory_bytes'] / 2**30:.2f} GiB", flush=True)
        if phase == "main_reaching":
            rmp = m
        elif phase == "main_push":
            ump = m
        elif phase == "main_box_sweep":
            bmp = m
            m["keypoints"] = box_keypoints(task)
        else:
            cmp = m
        done(phase)
    wmp = None
    if "main_mpc" in phases:
        wmp = record["main_mpc"] = main_mpc(walk)
        done("main_mpc")

    amp = None
    if "main_adaptive" in phases:
        amp = record["main_adaptive"] = main_adaptive(
            {"acrobot": acro, "reaching": reach})
        done("main_adaptive")

    if push_worker is not None:
        t0 = time.perf_counter()
        try:
            pw = _to(finish_worker(push_worker), "cuda")["push_ncl"]
        finally:
            if push_worker[0].poll() is None:
                push_worker[0].kill()
                push_worker[0].wait()
        print(f"plain half of the push check in a process of its own: "
              f"waited {time.perf_counter() - t0:.1f} s", flush=True)
        urow = check_kernels(push, PH, PB, time_them=True,
                             inputs=_to(torch.load(PUSH_INPUTS), "cuda"),
                             plain=pw)
        record["push_check"] = {
            k: {kk: vv for kk, vv in v.items() if kk != "bound"}
            for k, v in urow.items()}
        for name in LANE_KERNELS:
            print(f"check {name}: push_ncl {urow[name]['tol']} err "
                  f"{urow[name]['err'][1]:.3e}", flush=True)
        done("push_check")
    hold_push = None
    if "main_async" in phases:
        record["main_async"], hold_push = main_async(push, walk)
        record["k5_main_shapes"] = k5_main_shapes(reach, walk)
        done("main_async")

    if "cli" in phases:
        runs = cli_runs(beside=hold_push)
        for k, (line, _, out) in runs.items():
            record[f"cli_{k}"] = out
            print(f"cli {k}: {line}", flush=True)
        done("cli")
    elif hold_push is not None:
        hold_push()
    if FAILED:
        raise RuntimeError(f"{len(FAILED)} checks failed: {FAILED}")
    if sorted(phases) != sorted(PHASES):
        print(f"phases {phases} passed; a subset prints no result",
              flush=True)
        sys.exit(4)

    sizes = {"acrobot": Sizes(acro), "reaching": Sizes(si1(reach)),
             "push_ncl": Sizes(si1(push)), "walker": Sizes(walk),
             "box_sweep": Sizes(si1(box)), "threeD_push": Sizes(si1(tdp)),
             "push_lcl": Sizes(si1(lcl)),
             "push_ccl": Sizes(si1(pushing.make_pushing("constrained",
                                                        device="cuda")))}
    # per step: the whole step, and the parts of the constraint solve and
    # the contact rows in it
    counts = record["ops_per_step"] = {
        name: {"step": step_ops(s), "constraint": constraint_ops(s),
               "contact": contact_ops(s),
               # K2c per (slot, lane): its values once, its 2n + nu columns
               "implicit_tangent": implicit_primal_ops(s)
               + (s.nx + s.nu) * implicit_column_ops(s),
               "ad_slot": ad_slot_ops(s),
               # least time of one lane's step at the card's FP64 peak
               "step_bound_ns": step_ops(s) / F64_OPS_PER_S * 1e9}
        for name, s in sizes.items()}
    for name in ("push_ncl", "box_sweep", "threeD_push", "push_lcl",
                 "push_ccl"):
        counts[name]["fk_bias"] = fk_bias_ops(sizes[name])
        counts[name]["fk"] = fk_ops(sizes[name])
    kernels = (kernel_entries("acrobot", rows, mp["launches"],
                              counts["acrobot"])
               + kernel_entries("reaching", rrow, rmp["launches"],
                                counts["reaching"],
                                rmp["kernel_ms"], rmp["bounds"],
                                f"H={RH} B={RB}", f"H={PH} B={PB}")
               + kernel_entries("push_ncl", urow, ump["launches"],
                                counts["push_ncl"],
                                ump["kernel_ms"], ump["bounds"],
                                f"H={UH} B={UB}", f"H={PH} B={PB}")
               + kernel_entries("walker", wrow, wmp["main"]["launches"],
                                counts["walker"], wmp["kernel_ms_b1"],
                                wmp["bounds_b1"],
                                f"H={MH} B=1, {N_REPLANS} replans",
                                f"H={WH} B={WB}")
               + box_entries(brows, bmp, counts, runs)
               + clutter_entries(crows, cmp, counts, runs))
    for e in kernels:
        if e["model"] == "walker":
            # the same kernels at MB episodes, and the whole kernel path
            # against the plain path over the first replans
            e["at_B128"] = {"ms": wmp["kernel_ms_b128"][e["name"]],
                            "bound_ms": wmp["bounds_b128"][e["name"]][0],
                            "held_against_twin": "chip_smoke.py --deep"}
            e["mpc_vs_plain"] = wmp.get(
                "plain_walker_run", "held by chip_smoke.py --deep")
    # fk_bias at the main path's own shape (UB lanes: the init servo's
    # start), its other checks beside it
    sc = ump["servo_check"]
    fk, wide = sc["fk_bias"][1], urow["fk_bias"]
    kernels.append({
        "name": "fk_bias", "model": "push_ncl", "route": "cuda",
        "source": "trajoptkp_tpu_torch/kernels/csrc/rollout.cu",
        "device_function": "trajoptkp_tpu_torch/kernels/csrc/step.cuh",
        "replaces": "trajoptkp_tpu/tasks/pushing.py:421",
        "launches": ump["servo"]["launches"].get("fk_bias", 0),
        "launched_by": f"the setup and init servo of the main path "
                       f"({pushing.SETUP_STEPS} + {UH} steps)",
        "max_abs_err": max(f["err"][0] for f in sc["fk_bias"] + [wide]),
        "ms": fk["ms"], "plain_ms": fk["plain_ms"],
        "bound_ms": fk["bound"][0], "bound_by": fk["bound"][1],
        "library_ms": None, "tolerance": fk["tol"],
        "shape": f"{fk['lanes']} lanes",
        "bitwise": all(f["bitwise"] for f in sc["fk_bias"] + [wide]),
        "servo_vs_plain_servo": {
            k: dict(steps=sc["steps"], max_abs_err=sc[k]["err"][0],
                    bitwise=sc[k]["bitwise"]) for k in ("setup", "init")},
        "at_check_states": {"lanes": wide["lanes"], "ms": wide["ms"],
                            "plain_ms": wide["plain_ms"],
                            "max_abs_err": wide["err"][0],
                            "bound_ms": wide["bound"][0]}})
    for e in kernels:
        if e["model"] == "acrobot" and e["name"] in prow:
            e["pentabot_err"] = prow[e["name"]]["err"][0]
        if e["model"] == "acrobot" and e["name"] == "fd_jacobian":
            e.update(launches=(runs["acrobot"][1] or {}).get(
                "launches", {}).get("fd_jacobian", 0),
                launched_by="the CLI's Optimise_once (generic solve, B = 1,"
                " velocity_change, deriv_mode fd)",
                shape=f"H={H} B={B}, SI_1 slots (check)")
    kernels += keypoint_entries(kps, amp)
    for e in kernels:
        if e["name"] == "backward" and e["model"] in sizes:
            s = sizes[e["model"]]
            e["geometry"] = ops.backward_geometry(s.nx, s.nu)._asdict()
    for e in kernels:
        if e["name"] == "ad_jacobian" and e["model"] in ("acrobot",
                                                         "reaching"):
            # K5 at the adaptive main path's per-lane slots
            tag = f"{e['model']} " + ("AJ_1_50" if e["model"] == "acrobot"
                                      else "AJ_5_100")
            a = amp[tag]
            e["adaptive_slots"] = {
                "method": tag, "shape": f"H={H if e['model'] == 'acrobot' else RH} "
                f"B={B if e['model'] == 'acrobot' else RB}, K_max "
                f"{a['K_max']}, {a['live_slots_first']} live slots",
                "ms": a["kernel_ms"]["ad_jacobian"],
                "launches": a["launches"].get("ad_jacobian", 0),
                "bound_ms": a["bounds"]["ad_jacobian"][0],
                "bound_by": a["bounds"]["ad_jacobian"][1]}
        if e["name"] == "ad_jacobian" and e["model"] == "push_ncl":
            # at the check size; its full shape is held in `--deep`
            full = kps["push_ncl AJ_5_100"]
            e["adaptive_slots"] = {
                "method": "AJ_5_100", "shape": f"{full['shape']}, K_max "
                f"{full['K_max']}, {full['live_slots']} live slots",
                "ms": full["ad_jacobian"]["ms"],
                "plain_ms": full["ad_jacobian"]["plain_ms"],
                "bound_ms": full["ad_jacobian"]["bound"][0],
                "bound_by": full["ad_jacobian"]["bound"][1],
                "bitwise": full["ad_jacobian"]["bitwise"]}
    # K5 (central FD) runs on the generic path alone: the async planner at
    # the default deriv_mode, held phase by phase at its shape (main_async)
    ma = record["main_async"]
    fd, fd_held = ma["fd_jacobian_b1"], ma["held_push_ncl_b1"]["fd_jacobian"]
    kernels.append({
        "name": "fd_jacobian", "model": "push_ncl", "route": "cuda",
        "source": "trajoptkp_tpu_torch/kernels/csrc/fd_jacobian.cu",
        "replaces": ops.REPLACES["fd_jacobian"],
        "launches": ma["push_ncl"]["launches"]["fd_jacobian"],
        "launched_by": "the async planner (generic solve, deriv_mode fd)",
        "max_abs_err": fd_held["max_abs_err"], "bitwise": fd_held["bitwise"],
        "ms": fd["ms"], "plain_ms": fd["plain_ms"],
        "bound_ms": fd["bound"][0], "bound_by": fd["bound"][1],
        "library_ms": None, "tolerance": "bit for bit",
        "shape": fd["shape"]})
    # K5 at the async walker planner's and reaching's CLI solve's shapes
    for model, r, n, by in (
            ("walker", record["k5_main_shapes"]["walker"],
             ma["walker"]["launches"]["fd_jacobian"],
             "the async walker planner (generic solve, deriv_mode fd)"),
            ("reaching", record["k5_main_shapes"]["reaching"],
             (runs["reaching"][1] or {}).get("launches", {}).get(
                 "fd_jacobian", 0),
             "the CLI's Optimise_once (generic solve, B = 1, "
             "velocity_change, deriv_mode fd)")):
        kernels.append({
            "name": "fd_jacobian", "model": model, "route": "cuda",
            "source": "trajoptkp_tpu_torch/kernels/csrc/fd_jacobian.cu",
            "replaces": ops.REPLACES["fd_jacobian"], "launches": n,
            "launched_by": by, "max_abs_err": r["max_abs_err"],
            "bitwise": r["bitwise"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None,
            "tolerance": "bit for bit", "shape": r["shape"]})
    k35_routes(kernels)
    k35 = record["k3_k5_ms"] = k35_summary(record, mp, rmp, ump, bmp, cmp,
                                           wmp)
    print(f"K3 and K5 ms per launch on the main paths ({card}): "
          f"{json.dumps(k35)}", flush=True)
    record["seconds"] = time.perf_counter() - t_start
    print(f"chip_smoke: {record['seconds']:.1f} s in all, build phase "
          f"{phase_s['build']:.1f} s (nvcc {build_s:.1f} s)", flush=True)
    print("record " + json.dumps(record), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
