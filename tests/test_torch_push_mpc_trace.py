"""Does MPC on push_ncl close on the object?  The async push_ncl trials on
the card left the object in place (ROADMAP Queue 3 item 1), so the lane
sync executors, JAX `mpc/sync.py:make_lane_sync_mpc_host` and the port's,
run deterministically on the CPU in float64 from the async campaign's first
start (`async_scenes`, seed 0: the pusher 0.327 m from the object), SI_1,
one iteration a replan at H 10, five controls applied each with the JAX
noise stream (5% of the control range, PRNGKey 0).

JAX's replan is slow on a CPU: jitted at panda width it was still compiling
after 10 minutes when its process was killed, and run eagerly
(`jax.disable_jit`) it takes ~150 s a replan.  So JAX runs the first
N_HELD replans eagerly (TRAJOPT_TRACE_JAX_REPLANS, 2 by default; 60 runs
the whole episode in ~2.5 hours) and the port must follow it there
(states within 1e-6, as tests/test_torch_mpc.py holds acrobot); the port
runs all N_REPLANS replans (300 steps of 8 ms), and the object's
horizontal displacement and the pusher-to-object distance (the task's last
residual) along the episode are the trace.

`-m slow`: ~10 minutes at the default.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.mpc import sync as jsync
from trajoptkp_tpu.solver.ilqr import ILQRConfig as JConfig
from trajoptkp_tpu.tasks.pushing import make_pushing as jax_pushing
from trajoptkp_tpu_torch.bench.campaigns import async_scenes
from trajoptkp_tpu_torch.mpc import sync as psync
from trajoptkp_tpu_torch.solver.ilqr import ILQRConfig
from trajoptkp_tpu_torch.tasks.pushing import make_pushing

jax.config.update("jax_enable_x64", True)

H, NUM_APPLY, NOISE_PCT = 10, 5, 5.0
N_REPLANS = 60
N_HELD = int(os.environ.get("TRAJOPT_TRACE_JAX_REPLANS", "2"))
STATE_ATOL, COST_RTOL = 1e-6, 1e-6


def _si1(task):
    return task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name="set_interval", min_N=1))


def _noise(key, nu):
    """The JAX apply loop's draws, (N_REPLANS, NUM_APPLY, nu, 1)."""
    z = []
    for _ in range(N_REPLANS * NUM_APPLY):
        key, sub = jax.random.split(key)
        z.append(np.asarray(jax.random.normal(sub, (nu, 1), jnp.float64)))
    return np.stack(z).reshape(N_REPLANS, NUM_APPLY, nu, 1)


def _track(task, qpos, qvel):
    """(object's horizontal displacement from its start, pusher-to-object
    distance) at every step of one episode (qpos (T, nq), qvel (T, nv))."""
    m = task.model
    qa = m.jnt_qposadr[m.joint_names.index("goal")]
    disp = np.linalg.norm(qpos[:, qa:qa + 2] - qpos[:1, qa:qa + 2], axis=1)
    f64 = dict(dtype=torch.float64)
    r = task.residual_fn(torch.as_tensor(qpos.T, **f64),
                         torch.as_tensor(qvel.T, **f64),
                         torch.zeros((m.nu, qpos.shape[0]), **f64),
                         task.residual_targets[:, None].expand(
                             -1, qpos.shape[0]))
    return disp, r[-1].numpy()


@pytest.mark.slow
def test_push_ncl_sync_mpc_trace():
    """The port's lane sync MPC follows JAX's on push_ncl over the replans
    JAX can run here, and over 300 steps the pusher does not close on the
    object: its closest approach stays centimetres away and the object
    stays where it settled, as on the card's async trials."""
    jt = _si1(jax_pushing(0))
    pt = _si1(make_pushing(0, device="cpu"))
    qp0 = async_scenes(pt, 1)[0]
    qv0 = pt.qvel_start.numpy()
    U0 = np.zeros((1, H, pt.model.nu))
    key = jax.random.PRNGKey(0)
    tg = pt.residual_targets.numpy()[None]
    run_j = jsync.make_lane_sync_mpc_host(
        jt, JConfig(max_iterations=1, min_iterations=1), H, NUM_APPLY,
        NOISE_PCT)
    with jax.disable_jit():
        res_j = run_j(jnp.asarray(qp0[None]), jnp.asarray(qv0[None]),
                      jnp.asarray(U0), jnp.asarray(tg), N_HELD, key)
    run = psync.make_lane_sync_mpc_host(pt, ILQRConfig(), H, NUM_APPLY,
                                        NOISE_PCT)
    res = run(torch.from_numpy(qp0[None]), torch.from_numpy(qv0[None]),
              torch.from_numpy(U0), torch.from_numpy(tg), N_REPLANS,
              torch.from_numpy(_noise(key, pt.model.nu)))
    n = N_HELD * NUM_APPLY + 1
    gap = float(np.abs(res.qpos_hist[:n].numpy()
                       - np.asarray(res_j.qpos_hist)).max())
    disp, dist = _track(pt, res.qpos_hist[..., 0].numpy(),
                        res.qvel_hist[..., 0].numpy())
    jdisp, jdist = _track(pt, np.asarray(res_j.qpos_hist)[..., 0],
                          np.asarray(res_j.qvel_hist)[..., 0])
    every = 10 * NUM_APPLY
    print(f"push_ncl sync MPC at H {H}: state gap to JAX over the first "
          f"{n - 1} steps {gap:.3e}; every {every} steps, the object's "
          f"displacement {disp[::every].tolist()} m (JAX "
          f"{jdisp[::every].tolist()}) and the pusher-object distance "
          f"{dist[::every].tolist()} m (JAX {jdist[::every].tolist()}; "
          f"closest {float(dist.min()):.4f}, JAX {float(jdist.min()):.4f}); "
          f"replan costs {res.replan_costs[:, 0].tolist()}")
    np.testing.assert_allclose(res.qpos_hist[:n].numpy(),
                               np.asarray(res_j.qpos_hist), atol=STATE_ATOL)
    np.testing.assert_allclose(res.ctrl_hist[:n - 1].numpy(),
                               np.asarray(res_j.ctrl_hist), atol=STATE_ATOL)
    np.testing.assert_allclose(res.replan_costs[:N_HELD].numpy(),
                               np.asarray(res_j.replan_costs),
                               rtol=COST_RTOL)
    assert np.isfinite(res.qpos_hist.numpy()).all()
    assert float(dist.min()) > 0.25 and float(disp.max()) < 0.005
