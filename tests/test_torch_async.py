"""The port's asynchronous MPC (`mpc/async_mpc.py`, `mpc/native_executor.py`,
`bench/campaigns.py:async_mpc_campaign`, the CLI's MPC_until_completion and
Generate_asynchronus_mpc_data) on the CPU, held piece by piece: the
wall-clock interleaving of planner and actor is not repeatable, so no
whole episode is compared with JAX.

- the native plan buffer and ticker, built from the port's own copy of the
  source, with the cases of tests/test_native_executor.py, and the Python
  `ControlBuffer`;
- the acrobot's, push_ncl's and the walker's completion tests against JAX
  at states on either side of the thresholds;
- the actor's step (K3's twin at H = 1) and its gravity hold (fk_bias's
  twin) against JAX `step` and `forward` on acrobot (the step bars of
  tests/test_torch_step.py: rtol 1e-10, atol 1e-12);
- the noise stream: the applied controls equal JAX's formula with
  `np.random.default_rng(seed)` exactly;
- `episode_cost` against JAX `AsyncMPC.episode_cost` on the same visited
  states (1e-12 relative: the sums run in other orders);
- the best_match resync index;
- one planner step (`optimise` at one iteration) against JAX
  `make_fused_optimise` at one iteration, acrobot SI_1 H = 30, at
  tests/test_torch_mpc.py's generic bars (states and controls 1e-6, cost
  1e-6 relative: the port's Jacobians are central FD, JAX's exact);
- a planner exception that fails `run()`, episodes that end, with and
  without real-time pacing, and both CLI modes writing their output.
"""

import json
import os
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.dynamics.fk import forward_kinematics as jax_fk
from trajoptkp_tpu.dynamics.model import Data as JData
from trajoptkp_tpu.dynamics.step import forward as jax_forward
from trajoptkp_tpu.dynamics.step import step as jax_step
from trajoptkp_tpu.mpc.async_mpc import AsyncMPC as JAsyncMPC
from trajoptkp_tpu.solver.fused import make_fused_optimise
from trajoptkp_tpu.solver.ilqr import ILQRConfig as JConfig
from trajoptkp_tpu.tasks.base import control_limits as jax_limits
from trajoptkp_tpu.tasks.locomotion import make_walker as jax_walker
from trajoptkp_tpu.tasks.pushing import make_pushing as jax_pushing
from trajoptkp_tpu.tasks.toys import make_acrobot as jax_acrobot
from trajoptkp_tpu.tasks.toys import make_pentabot as jax_pentabot
from trajoptkp_tpu_torch import app
from trajoptkp_tpu_torch.kernels.build import BUILD_DIR
from trajoptkp_tpu_torch.mpc import async_mpc as pasync
from trajoptkp_tpu_torch.mpc import native_executor as pnative
from trajoptkp_tpu_torch.solver.ilqr import ILQRConfig
from trajoptkp_tpu_torch.tasks.locomotion import make_walker
from trajoptkp_tpu_torch.tasks.pushing import make_pushing
from trajoptkp_tpu_torch.tasks.toys import make_acrobot, make_pentabot

jax.config.update("jax_enable_x64", True)

STATE_ATOL, COST_RTOL = 1e-6, 1e-6


def _si(task, n):
    return task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name="set_interval", min_N=n))


# ---- the plan buffers and the ticker ---------------------------------------


def test_native_library_is_the_ports_own_build():
    path = pnative.build()
    assert path.parent == BUILD_DIR and path.name.startswith("executor-")
    assert path.exists()


def test_native_buffer_publish_pop():
    buf = pnative.NativeControlBuffer(horizon=4, nu=2)
    assert buf.next_control() is None            # empty until first publish
    buf.publish(np.arange(8, dtype=np.float64).reshape(4, 2), start_index=1)
    np.testing.assert_array_equal(buf.next_control(), [2, 3])
    np.testing.assert_array_equal(buf.next_control(), [4, 5])
    np.testing.assert_array_equal(buf.next_control(), [6, 7])
    assert buf.next_control() is None            # exhausted: an underrun
    assert buf.stats["underruns"] >= 1
    assert buf.stats["controls_consumed"] == 3
    with pytest.raises(ValueError, match="shape"):
        buf.publish(np.zeros((3, 2)))


def test_native_buffer_republish_resets_index():
    buf = pnative.NativeControlBuffer(horizon=3, nu=1)
    buf.publish(np.array([[1.0], [2.0], [3.0]]), start_index=0)
    np.testing.assert_array_equal(buf.next_control(), [1.0])
    buf.publish(np.array([[10.0], [20.0], [30.0]]), start_index=1)
    np.testing.assert_array_equal(buf.next_control(), [20.0])
    assert buf.consumed() == 2


def test_native_buffer_concurrent_publish_pop():
    """A planner thread republishing while the actor pops: every pop is a
    row of one published plan (no tearing)."""
    H, nu = 16, 3
    buf = pnative.NativeControlBuffer(H, nu)
    stop = threading.Event()

    def planner():
        gen = 1
        while not stop.is_set():
            buf.publish(np.full((H, nu), float(gen)), start_index=0)
            gen += 1

    th = threading.Thread(target=planner, daemon=True)
    th.start()
    t0, pops = time.time(), 0
    while time.time() - t0 < 0.5:
        u = buf.next_control()
        if u is not None:
            assert u[0] == u[1] == u[2], u
            pops += 1
    stop.set()
    th.join(timeout=2)
    assert pops > 100


def test_native_ticker_paces():
    t = pnative.RtTicker(0.002)
    t0 = time.perf_counter()
    for _ in range(50):
        t.wait()
    elapsed = time.perf_counter() - t0
    assert 0.08 <= elapsed <= 0.25, elapsed      # 50 x 2 ms with slack
    assert t.ticks == 50


def test_launch_counts_survive_concurrent_launches():
    """The planner and the actor count their launches from two threads:
    sixteen threads adding 2000 each, with a shortened switch interval, lose
    no count."""
    from trajoptkp_tpu_torch.kernels import ops

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ops.reset_launch_counts()
        threads = [threading.Thread(target=lambda: [
            ops.count_launch("rollout") for _ in range(2000)])
            for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert ops.LAUNCHES["rollout"] == 16 * 2000
    finally:
        sys.setswitchinterval(switch)
        ops.reset_launch_counts()


def test_python_control_buffer():
    buf = pasync.ControlBuffer()
    assert not buf.has_plan() and buf.next_control() is None
    buf.install(np.arange(6.0).reshape(3, 2), 1)
    assert buf.has_plan()
    np.testing.assert_array_equal(buf.next_control(), [2.0, 3.0])
    np.testing.assert_array_equal(buf.next_control(), [4.0, 5.0])
    assert buf.next_control() is None and buf.consumed() == 3


def test_realtime_needs_the_native_buffer():
    """Real-time pacing is the native ticker's: the Python buffer, a test
    aid, is refused for a real-time episode."""
    pt = _si(make_acrobot(device="cpu"), 5)
    with pytest.raises(ValueError, match="native"):
        pasync.AsyncMPC(pt, ILQRConfig(), 10, realtime=True, buffer="python")


# ---- completion, the actor's step, its noise and the episode cost ----------


def test_completion_functions_match_jax():
    """Acrobot: done when sum |q_i - tq_i| < 0.01, at seeded states on both
    sides of the threshold; the walker never completes; pentabot has no
    test in either package."""
    jt, pt = jax_acrobot(dtype=jnp.float64), make_acrobot(device="cpu")
    rng = np.random.default_rng(4)
    tq = pt.residual_targets.numpy()[:2]
    offsets = [0.003 * rng.standard_normal(2), 0.02 * rng.standard_normal(2),
               np.array([0.0049, -0.0049]), np.array([0.0051, 0.0051])]
    qp = np.stack([tq + o for o in offsets], 1)            # (2, 4)
    done, dist = pt.task_complete_fn(torch.from_numpy(qp),
                                     pt.residual_targets[:, None])
    for i in range(qp.shape[1]):
        d = JData(qpos=jnp.asarray(qp[:, i]), qvel=jnp.zeros(2),
                  ctrl=jnp.zeros(1), time=jnp.zeros(()))
        jd, jdist = jt.task_complete_fn(jt.model, d, jt.residual_targets)
        assert bool(done[i]) == bool(jd)
        np.testing.assert_allclose(float(dist[i]), float(jdist), rtol=1e-14)
    assert done.tolist() == [True, False, True, False]

    jw, pw = jax_walker(run=True, dtype=jnp.float64), make_walker(
        run=True, device="cpu")
    q = pw.qpos_start.numpy()
    jd, jdist = jw.task_complete_fn(
        jw.model, JData(qpos=jnp.asarray(q), qvel=jnp.zeros(9),
                        ctrl=jnp.zeros(6), time=jnp.zeros(())),
        jw.residual_targets)
    done, dist = pw.task_complete_fn(torch.from_numpy(q)[:, None],
                                     pw.residual_targets[:, None])
    assert not bool(jd) and not bool(done[0])
    assert float(dist[0]) == float(jdist) == 0.0
    assert make_pentabot(device="cpu").task_complete_fn is None
    assert jax_pentabot(dtype=jnp.float64).task_complete_fn is None

    # push_ncl: the goal within 0.025 of the target in xy (the port reads
    # the free goal's qpos, JAX its FK position; the port's norm keeps the
    # residual's 1e-12 under its root, 1.25e-9 relative at d = 0.02)
    jp, pp = jax_pushing(0), make_pushing(device="cpu")
    m = pp.model
    qa = m.jnt_qposadr[m.joint_names.index("goal")]
    jfn = jax.jit(lambda q: jp.task_complete_fn(jp.model, jax_fk(
        jp.model, JData(qpos=q, qvel=jnp.zeros(m.nv), ctrl=jnp.zeros(m.nu),
                        time=jnp.zeros(()))), jp.residual_targets))
    tg = pp.residual_targets.numpy()
    qp = np.tile(pp.qpos_start.numpy()[:, None], (1, 4))
    for i, (dx, dy) in enumerate([(0.02, 0.0), (0.0, -0.03), (0.01, 0.02),
                                  (0.3, 0.1)]):
        qp[qa:qa + 3, i] = (tg[0] + dx, tg[1] + dy, 0.032)
    done, dist = pp.task_complete_fn(torch.from_numpy(qp),
                                     pp.residual_targets[:, None])
    for i in range(4):
        jd, jdist = jfn(jnp.asarray(qp[:, i]))
        assert bool(done[i]) == bool(jd)
        np.testing.assert_allclose(float(dist[i]), float(jdist), rtol=1e-8)
    assert done.tolist() == [True, False, True, False]


@pytest.fixture(scope="module")
def acro():
    return jax_acrobot(dtype=jnp.float64), make_acrobot(device="cpu")


def test_actor_step_and_gravity_hold_match_jax(acro):
    jt, pt = acro
    runner = pasync.AsyncMPC(pt, ILQRConfig(), 10, buffer="python")
    rng = np.random.default_rng(6)
    jstep = jax.jit(lambda d: jax_step(jt.model, d))
    jfwd = jax.jit(lambda d: jax_forward(jt.model, d))
    for _ in range(4):
        q, v = rng.standard_normal(2), rng.standard_normal(2)
        u = rng.uniform(-1, 1, 1)
        d = JData(qpos=jnp.asarray(q), qvel=jnp.asarray(v),
                  ctrl=jnp.asarray(u), time=jnp.zeros(()))
        qn, vn = runner.step(*(torch.from_numpy(x)[:, None]
                               for x in (q, v, u)))
        out = jstep(d)
        np.testing.assert_allclose(qn[:, 0].numpy(), np.asarray(out.qpos),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(vn[:, 0].numpy(), np.asarray(out.qvel),
                                   rtol=1e-10, atol=1e-12)
        hold = runner.gravity_hold(torch.from_numpy(q)[:, None],
                                   torch.from_numpy(v)[:, None])
        f = jfwd(d)
        m = jt.model
        want = [float(f.qfrc_bias[m.jnt_dofadr[m.actuator_trnid[a]]])
                / float(m.actuator_gear[a, 0]) for a in range(m.nu)]
        np.testing.assert_allclose(hold[:, 0].numpy(), want, rtol=1e-10,
                                   atol=1e-12)


def _actor_steps(pt, plan, seed, n):
    runner = pasync.AsyncMPC(pt, ILQRConfig(), plan.shape[0], seed=seed,
                             buffer="python")
    runner.buffer.install(plan, 0)
    for _ in range(n):
        runner._actor_step()
    return runner


def test_noise_stream_and_episode_cost_match_jax(acro):
    """The applied controls are clip(plan + rng.normal(0, 5% of range)) with
    rng = np.random.default_rng(seed), drawn as JAX's actor draws them, bit
    for bit; the same seed repeats them.  The episode cost of the visited
    states equals JAX `AsyncMPC.episode_cost` (called on those states)."""
    jt, pt = acro
    plan = 0.8 * np.random.default_rng(1).standard_normal((6, 1))
    runner = _actor_steps(pt, plan, seed=3, n=6)
    lim = np.asarray(jax_limits(jt))
    width = lim[:, 1] - lim[:, 0]
    std = np.where(np.isfinite(width), width, 0.0) / 100.0 * 5.0
    rng = np.random.default_rng(3)
    want = [np.clip(plan[t] + rng.normal(0.0, std), lim[:, 0], lim[:, 1])
            for t in range(6)]
    assert np.array_equal(np.array(runner.applied_controls), np.array(want))
    again = _actor_steps(pt, plan, seed=3, n=6)
    assert np.array_equal(np.array(again.visited_qpos),
                          np.array(runner.visited_qpos))

    stub = types.SimpleNamespace(
        visited_qpos=runner.visited_qpos, visited_qvel=runner.visited_qvel,
        applied_controls=runner.applied_controls, model=jt.model, task=jt)
    want_cost = JAsyncMPC.episode_cost(stub)
    got = runner.episode_cost()
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want_cost, rtol=1e-12)


def test_best_match_index():
    """The plan step nearest (L1 over qpos and qvel) to the current state
    among the first H - 1, as JAX's planner computes it."""
    rng = np.random.default_rng(9)
    H = 12
    qp, qv = rng.standard_normal((H + 1, 2)), rng.standard_normal((H + 1, 2))
    for k in (0, 7, H - 2):
        cur_q, cur_v = qp[k] + 1e-3, qv[k] - 1e-3
        X_old = np.concatenate([qp, qv], axis=1)
        cur = np.concatenate([cur_q, cur_v])
        jax_idx = int(np.argmin(np.abs(X_old[:H - 1] - cur[None]).sum(1)))
        assert pasync.best_match_index(qp, qv, cur_q, cur_v, H) == jax_idx == k


def test_planner_step_matches_jax_fused_one_iteration(acro):
    jt, pt = acro
    H = 30
    jt, pt = _si(jt, 1), _si(pt, 1)
    U = 0.3 * np.random.default_rng(2).standard_normal((H, 1))
    q0 = pt.qpos_start.numpy() + 0.1
    v0 = np.array([0.2, -0.1])
    res = jax.jit(make_fused_optimise(
        jt, JConfig(max_iterations=1, min_iterations=1), H))(
            jnp.asarray(q0), jnp.asarray(v0), jnp.asarray(U))
    runner = pasync.AsyncMPC(pt, ILQRConfig(), H, buffer="python")
    traj, st = runner.replan(q0, v0, U)
    np.testing.assert_allclose(traj.ctrl.numpy(), np.asarray(res.traj.ctrl),
                               atol=STATE_ATOL)
    np.testing.assert_allclose(traj.qpos.numpy(), np.asarray(res.traj.qpos),
                               atol=STATE_ATOL)
    np.testing.assert_allclose(traj.qvel.numpy(), np.asarray(res.traj.qvel),
                               atol=STATE_ATOL)
    np.testing.assert_allclose(float(traj.costs.sum()),
                               float(res.final_cost), rtol=COST_RTOL)
    np.testing.assert_allclose(st.final_cost, float(res.final_cost),
                               rtol=COST_RTOL)


# ---- episodes ---------------------------------------------------------------


def test_planner_exception_fails_run(monkeypatch):
    """The planner's first plan is good, its second raises once the actor
    has applied three controls: run() stops the actor and raises, with the
    planner's error as the cause."""
    pt = _si(make_acrobot(device="cpu"), 5)
    runner = pasync.AsyncMPC(pt, ILQRConfig(), 10)
    calls = []
    real = runner.replan

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) > 1:
            t0 = time.perf_counter()
            while (len(runner.applied_controls) < 3
                   and time.perf_counter() - t0 < 60):
                time.sleep(1e-3)
            raise ValueError("planner fault")
        return real(*a, **k)

    monkeypatch.setattr(runner, "replan", flaky)
    with pytest.raises(RuntimeError, match="planner failed") as e:
        runner.run(np.zeros((10, 1)), max_steps=10 ** 6)
    assert isinstance(e.value.__cause__, ValueError)
    assert 3 <= len(runner.applied_controls) < 10 ** 6


@pytest.mark.parametrize("realtime", [False, True])
def test_acrobot_episode_ends(realtime):
    """A whole episode on the CPU ends after max_steps (or on completion),
    with finite states, at least one plan and the stats filled in; with
    real-time pacing the native ticker paces the actor at the timestep."""
    pt = _si(make_acrobot(device="cpu"), 5)
    runner = pasync.AsyncMPC(pt, ILQRConfig(), 20, realtime=realtime,
                             seed=1)
    t0 = time.perf_counter()
    qh, uh = runner.run(np.zeros((20, 1)), max_steps=40)
    wall = time.perf_counter() - t0
    assert 1 <= len(uh) <= 40 and qh.shape == (len(uh), 2)
    assert np.isfinite(qh).all() and np.isfinite(runner.episode_cost())
    st = runner.stats()
    assert st["replans"] >= 1 and st["steps"] == len(uh)
    assert st["timing"] == "host clock"
    assert st["buffer"]["plans_published"] == st["replans"]
    assert st["holds"] == st["buffer"]["underruns"]
    assert len(runner.plan_cost_reduction) == st["replans"]
    assert all(r >= 0.0 for r in runner.plan_cost_reduction)
    if realtime:
        assert wall >= 0.95 * len(uh) * float(pt.model.timestep)


def test_cli_async_modes_on_the_cpu(tmp_path, capsys, monkeypatch):
    """Generate_asynchronus_mpc_data --num_scenes 1 --device cpu writes
    async_mpc.csv with the JAX columns and one trial; MPC_until_completion
    prints its JSON line; --scenes_dir names the ROADMAP item.  The actor
    steps per episode (500 and 2000) are cut to 60 and 30 here, as the sync
    campaign's CLI test cuts its replans: a plain replan on this CPU takes
    ~0.3 s at H = 100."""
    monkeypatch.setattr(app, "ASYNC_CAMPAIGN_STEPS", 60)
    app.main(["--device", "cpu", "--runMode", "Generate_asynchronus_mpc_data",
              "--num_scenes", "1", "--keypoint", "SI_5", "--out_dir",
              str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["trials"] == 1
    with open(os.path.join(out["campaign"], "async_mpc.csv")) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == ("trial,steps,wall_s,replans,mean_replan_ms,"
                        "final_dist,episode_cost,task_complete")
    assert len(lines) == 2 and lines[1].startswith("0,")
    row = out["rows"][0]
    assert row["steps"] <= 60 and row["replans"] >= 1

    monkeypatch.setattr(app, "ASYNC_MPC_STEPS", 30)
    app.main(["--device", "cpu", "--runMode", "MPC_until_completion",
              "--keypoint", "SI_5"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["task"] == "acrobot" and res["steps"] <= 30
    assert res["replans"] >= 1 and res["horizon"] == 100
    with pytest.raises(NotImplementedError, match="the YAML/CSV layer"):
        app.main(["--device", "cpu", "--runMode",
                  "Generate_asynchronus_mpc_data", "--scenes_dir", "x"])
