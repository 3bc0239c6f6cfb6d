"""The port's synchronous MPC (plain path) against the JAX package.

Acrobot SI_1, H = 40, 6 replans of one iteration, num_apply = 2, one
episode, as `tests/test_lane_mpc.py` runs the JAX executors:

- the lane executor (`make_lane_sync_mpc`) against JAX `make_lane_sync_mpc`
  and the generic executor (`make_sync_mpc`) against JAX `make_sync_mpc`,
  with the noise off and with the JAX noise stream fed in
  (`key, sub = split(key); normal(sub, (nu, B))` per applied step, the key
  carried across replans, `sync.py:152-156`);
- the host-driven lane executor against the one that runs the replans back
  to back (bit for bit), and the generator-drawn noise repeated by its seed;
- K8's twin (`mpc/sync.py:apply_controls`) against the JAX apply loop of
  `_build_lane_replan` (`sync.py:148-177`) on the same inputs.

Tolerances: the JAX lane solver takes exact (jacfwd) Jacobians and the JAX
fused solver its own, the port central FD (eps 1e-6, noise ~1e-9 on the
Jacobians); over 6 replans through a chaotic swing-up that leaves the
states within 1e-6 and the replan and running costs within 1e-6 relative
(measured: states 9.4e-11, controls 5.4e-10, replan costs 1.0e-9 and
running costs 6.7e-9 relative).  The apply loop is one step of the same
arithmetic: 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.mpc import sync as jsync
from trajoptkp_tpu.solver.ilqr import ILQRConfig as JConfig
from trajoptkp_tpu.tasks.toys import make_acrobot as jax_acrobot
from trajoptkp_tpu_torch.mpc import sync as psync
from trajoptkp_tpu_torch.solver.ilqr import ILQRConfig
from trajoptkp_tpu_torch.tasks.toys import make_acrobot

jax.config.update("jax_enable_x64", True)

H, N_REPLANS, NUM_APPLY = 40, 6, 2
STATE_ATOL, COST_RTOL = 1e-6, 1e-6


def _si1(task):
    return task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name="set_interval", min_N=1))


@functools.lru_cache(maxsize=None)
def _jax_runs(noise_pct):
    """JAX lane and generic executors at the test's size, and the noise
    stream they drew (n_replans, num_apply, nu)."""
    jt = _si1(jax_acrobot(dtype=jnp.float64))
    cfg = JConfig(max_iterations=1, min_iterations=1)
    key = jax.random.PRNGKey(3)
    U0 = jnp.zeros((H, jt.model.nu), jnp.float64)
    lane = jsync.make_lane_sync_mpc(jt, cfg, H, num_apply=NUM_APPLY,
                                    noise_pct=noise_pct)
    res_l = jax.jit(lambda qp, qv, U, tg, k: lane(qp, qv, U, tg, N_REPLANS,
                                                  k))(
        jt.qpos_start[None], jt.qvel_start[None], U0[None],
        jt.residual_targets[None], key)
    gen = jsync.make_sync_mpc(jt, cfg, H, num_apply=NUM_APPLY,
                              noise_pct=noise_pct)
    res_g = jax.jit(lambda qp, qv, U, k: gen(qp, qv, U, N_REPLANS, k))(
        jt.qpos_start, jt.qvel_start, U0, key)
    z = []
    for _ in range(N_REPLANS * NUM_APPLY):
        key, sub = jax.random.split(key)
        z.append(np.asarray(jax.random.normal(sub, (jt.model.nu, 1),
                                              jnp.float64)))
    z = np.stack(z).reshape(N_REPLANS, NUM_APPLY, jt.model.nu, 1)
    return res_l, res_g, z


def _port_task():
    return _si1(make_acrobot(device="cpu"))


@pytest.mark.parametrize("noise_pct", [0.0, 5.0])
def test_lane_mpc_matches_jax_lane_mpc(noise_pct):
    res_j, _, z = _jax_runs(noise_pct)
    pt = _port_task()
    run = psync.make_lane_sync_mpc(pt, ILQRConfig(), H, NUM_APPLY, noise_pct)
    res = run(pt.qpos_start[None], pt.qvel_start[None],
              torch.zeros((1, H, 1), dtype=torch.float64),
              pt.residual_targets[None], N_REPLANS,
              torch.from_numpy(z))
    assert res.qpos_hist.shape == (N_REPLANS * NUM_APPLY + 1, 2, 1)
    np.testing.assert_allclose(res.qpos_hist.numpy(),
                               np.asarray(res_j.qpos_hist), atol=STATE_ATOL)
    np.testing.assert_allclose(res.ctrl_hist.numpy(),
                               np.asarray(res_j.ctrl_hist), atol=STATE_ATOL)
    np.testing.assert_allclose(res.replan_costs.numpy(),
                               np.asarray(res_j.replan_costs), rtol=COST_RTOL)
    np.testing.assert_allclose(res.cost_hist.numpy(),
                               np.asarray(res_j.cost_hist), rtol=COST_RTOL)


@pytest.mark.parametrize("noise_pct", [0.0, 5.0])
def test_generic_mpc_matches_jax_generic_mpc(noise_pct):
    _, res_j, z = _jax_runs(noise_pct)
    pt = _port_task()
    run = psync.make_sync_mpc(pt, ILQRConfig(), H, NUM_APPLY, noise_pct)
    res = run(pt.qpos_start, pt.qvel_start,
              torch.zeros((H, 1), dtype=torch.float64), N_REPLANS,
              torch.from_numpy(z[..., 0]))
    np.testing.assert_allclose(res.qpos_hist.numpy(),
                               np.asarray(res_j.qpos_hist), atol=STATE_ATOL)
    np.testing.assert_allclose(res.replan_costs.numpy(),
                               np.asarray(res_j.replan_costs), rtol=COST_RTOL)
    np.testing.assert_allclose(res.cost_hist.numpy(),
                               np.asarray(res_j.cost_hist), rtol=COST_RTOL)


def test_host_lane_mpc_matches_back_to_back_and_seeded_noise_repeats():
    pt = _port_task()
    B = 2
    qp = pt.qpos_start[None].expand(B, -1) + torch.tensor([[0.0, 0.0],
                                                           [0.1, -0.2]])
    args = (qp, torch.zeros((B, 2), dtype=torch.float64),
            torch.zeros((B, H, 1), dtype=torch.float64),
            pt.residual_targets[None].expand(B, -1))
    runs = []
    for make in (psync.make_lane_sync_mpc, psync.make_lane_sync_mpc_host):
        gen = torch.Generator().manual_seed(11)
        mpc = make(pt, ILQRConfig(), H, NUM_APPLY, 5.0)
        runs.append(mpc(*args, 4, gen))
    assert len(mpc.last_replan_ms) == 4
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    # the generator's draws are the tensor the executor takes
    gen = torch.Generator().manual_seed(11)
    z = torch.stack([torch.randn((NUM_APPLY, 1, B), generator=gen,
                                 dtype=torch.float64) for _ in range(4)])
    fed = psync.make_lane_sync_mpc(pt, ILQRConfig(), H, NUM_APPLY, 5.0)(
        *args, 4, z)
    for a, b in zip(runs[0], fed):
        assert torch.equal(a, b)


def _apply_inputs(nq, nv, nu, B, n_apply, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        qp=rng.standard_normal((nq, B)), qv=rng.standard_normal((nv, B)),
        U=rng.standard_normal((H, nu, B)), U_n=rng.standard_normal((H, nu, B)),
        accept=rng.random(B) < 0.5, best=rng.random(B), old=rng.random(B),
        z=rng.standard_normal((n_apply, nu, B)))


def test_apply_twin_matches_jax_apply_loop():
    """K8's twin against the JAX apply loop, its blend and its shift-pad,
    written out from `_build_lane_replan` (`sync.py:148-177`) on the JAX
    lane step, at 3 episodes, num_apply 3, half of them accepted."""
    from trajoptkp_tpu.dynamics.lanes import build_smooth_step
    from trajoptkp_tpu.dynamics.model import Data

    jt = _si1(jax_acrobot(dtype=jnp.float64))
    pt = _port_task()
    B, n_apply = 3, 3
    x = _apply_inputs(2, 2, 1, B, n_apply)
    std = 0.05 * np.asarray(jt.model.actuator_ctrlrange[:, 1]
                            - jt.model.actuator_ctrlrange[:, 0])
    lim = np.asarray(jt.model.actuator_ctrlrange)
    step_l = build_smooth_step(jt.model, want_fk=True)
    targets = np.repeat(np.asarray(jt.residual_targets)[:, None], B, 1)

    acc = x["accept"].astype(np.float64)
    U_new = acc * x["U_n"] + (1.0 - acc) * x["U"]
    qp, qv = jnp.asarray(x["qp"]), jnp.asarray(x["qv"])
    want_cs, want_us = [], []
    for t in range(n_apply):
        u = jnp.clip(U_new[t] + std[:, None] * x["z"][t],
                     lim[:, :1], lim[:, 1:])
        qp2, qv2, _ = step_l(qp, qv, u)
        data = Data(qpos=qp, qvel=qv, ctrl=u, time=jnp.zeros(()))
        r = jt.residual_fn(jt.model, data, jnp.asarray(targets))
        want_cs.append(np.asarray(jnp.sum(jt.weights[:, None] * r * r, 0)))
        want_us.append(np.asarray(u))
        qp, qv = qp2, qv2
    want_shift = np.concatenate([U_new[n_apply:],
                                 np.repeat(U_new[-1:], n_apply, 0)])

    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    out = psync.apply_controls(
        pt, t["qp"], t["qv"], t["U"], t["U_n"], t["accept"], t["best"],
        t["old"], t["z"], psync.noise_std(pt, 5.0),
        torch.from_numpy(targets))
    qp2, qv2, U_shift, qps, qvs, us, cs, rcost = (o.numpy() for o in out)
    np.testing.assert_allclose(qp2, np.asarray(qp), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(qv2, np.asarray(qv), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(U_shift, want_shift)
    np.testing.assert_array_equal(us, np.stack(want_us))
    np.testing.assert_allclose(cs, np.stack(want_cs), rtol=1e-12)
    np.testing.assert_array_equal(qps[0], x["qp"])
    np.testing.assert_array_equal(
        rcost, np.where(x["accept"], x["best"], x["old"]))


def test_a_plain_set_names_k8_as_it_names_the_other_kernels(monkeypatch):
    """`plain` as a set of kernel names: "mpc_apply" runs K8's twin and no
    other kernel's, another name leaves K8 a kernel, an unknown name
    raises."""
    from trajoptkp_tpu_torch.kernels import ops
    from trajoptkp_tpu_torch.solver.lanes import lane_phases

    pt = _port_task()
    with pytest.raises(ValueError, match="unknown kernels"):
        lane_phases(pt, ILQRConfig(), H, {"mpc_aply"})
    seen = []
    real = ops.mpc_apply

    def spy(*args, plain=False):
        seen.append(plain)
        return real(*args, plain=plain)

    monkeypatch.setattr(ops, "mpc_apply", spy)
    args = (pt.qpos_start[:, None], pt.qvel_start[:, None],
            torch.zeros((H, 1, 1), dtype=torch.float64),
            torch.zeros((NUM_APPLY, 1, 1), dtype=torch.float64),
            pt.residual_targets[:, None])
    for plain in ({"mpc_apply"}, {"rollout", "backward"}, True, False):
        psync._build_lane_replan(pt, ILQRConfig(), H, 5.0, plain)(*args)
    assert seen == [True, False, True, False]


def test_cli_runs_the_sync_mpc_campaign_on_the_cpu(tmp_path, capsys,
                                                    monkeypatch):
    """`Generate_syncronus_mpc_data --device cpu` at a tiny horizon: one row
    with the JAX campaign's keys, `mpc_horizons.csv` with its columns; the
    run modes not ported yet raise, naming their ROADMAP item (the async
    modes are ported: tests/test_torch_async.py runs them); without a card
    and without `--device cpu` the campaign raises."""
    import json

    from trajoptkp_tpu_torch import app
    from trajoptkp_tpu_torch.bench.campaigns import CSV_COLUMNS

    monkeypatch.setattr(app, "SYNC_MPC_REPLANS", 3)
    app.main(["--device", "cpu", "--task", "walker_run", "--runMode",
              "Generate_syncronus_mpc_data", "--horizon", "3", "--out_dir",
              str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (row,) = out["rows"]
    assert row["horizon"] == 3 and row["n_replans"] == 3
    for key in CSV_COLUMNS.split(","):
        assert np.isfinite(row[key])
    assert row["p95_opt_time_ms"] >= row["median_opt_time_ms"] > 0
    with open(f"{out['campaign']}/mpc_horizons.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == CSV_COLUMNS and lines[1].startswith("3,")
    for mode in ("Init_controls", "Generate_openloop_data"):
        with pytest.raises(NotImplementedError, match="harness, config, CLI and bench"):
            app.main(["--device", "cpu", "--task", "walker_run",
                      "--runMode", mode])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app.main(["--task", "walker_run", "--runMode",
                  "Generate_syncronus_mpc_data", "--horizon", "3"])
