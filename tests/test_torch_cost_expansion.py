"""K6, the Gauss-Newton cost expansion: the port's closed-form twin
(`solver/lanes.py:cost_expansion`, kernel K6's plain version) against the
JAX lane program it replaces (`make_lane_batch_optimise(...).phases
["cost_expansion"]`, jacfwd of the residual and two einsums, jitted),
float64 on the CPU, at all five models: acrobot, pentabot, reaching,
push_ncl and the walker; H = 6 steps, 3 lanes.

push_ncl's states are the servo's starts (the task's scenes: the arm at
its start pose, the goal on the table) with the arm joints moved by
0.1 N(0, 1) a step, the goal at random on the table, a quarter of a turn
tilted or upright, and random velocities; the other models take N(0, 1)
states and controls.

Tolerance: each output within 1e-12 of the largest magnitude of JAX's
(the closed form and jacfwd round alike only up to the last bits: push_ncl
measured ~1e-16 relative, the linear residuals exactly equal); an output
that JAX has exactly zero (l_u and l_uu at reaching and push_ncl, whose
residuals have no control term) is exactly zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.solver.ilqr import ILQRConfig as JConfig
from trajoptkp_tpu.solver.lanes import make_lane_batch_optimise
from trajoptkp_tpu.tasks.locomotion import make_walker as jax_walker
from trajoptkp_tpu.tasks.pushing import make_pushing as jax_pushing
from trajoptkp_tpu.tasks.reaching import make_reaching as jax_reaching
from trajoptkp_tpu.tasks.toys import make_acrobot as jax_acrobot
from trajoptkp_tpu.tasks.toys import make_pentabot as jax_pentabot
from trajoptkp_tpu_torch.kernels import ops
from trajoptkp_tpu_torch.solver import lanes as planes
from trajoptkp_tpu_torch.tasks.locomotion import make_walker
from trajoptkp_tpu_torch.tasks.pushing import make_pushing
from trajoptkp_tpu_torch.tasks.reaching import make_reaching
from trajoptkp_tpu_torch.tasks.toys import make_acrobot, make_pentabot

jax.config.update("jax_enable_x64", True)

H, NLANE = 6, 3
REL = 1e-12

MODELS = {
    "acrobot": (lambda: jax_acrobot(dtype=jnp.float64), make_acrobot),
    "pentabot": (lambda: jax_pentabot(dtype=jnp.float64), make_pentabot),
    "reaching": (lambda: jax_reaching(dtype=jnp.float64), make_reaching),
    "push_ncl": (lambda: jax_pushing(0), make_pushing),
    "walker": (lambda: jax_walker(run=True, dtype=jnp.float64),
               lambda device: make_walker(run=True, device=device)),
}


def _states(pt, rng):
    """qpos (H+1, nq, B), qvel, U (H, nu, B), targets (ntgt, B)."""
    m = pt.model
    tg = np.repeat(pt.residual_targets.numpy()[:, None], NLANE, 1)
    if pt.residual_kind[0] != "push":
        return (rng.standard_normal((H + 1, m.nq, NLANE)),
                rng.standard_normal((H + 1, m.nv, NLANE)),
                rng.standard_normal((H, m.nu, NLANE)), tg)
    qa = m.jnt_qposadr[m.joint_names.index("goal")]
    q = np.tile(pt.qpos_start.numpy()[None, :, None], (H + 1, 1, NLANE))
    q[:, :7] += 0.1 * rng.standard_normal((H + 1, 7, NLANE))
    for b in range(NLANE):
        tilt = 0.4 if b == 1 else 0.0
        q[:, qa:qa + 7, b] = (rng.uniform(0.4, 0.6), rng.uniform(-0.2, 0.2),
                              0.032, np.cos(tilt / 2), np.sin(tilt / 2), 0, 0)
    return (q, 0.1 * rng.standard_normal((H + 1, m.nv, NLANE)),
            0.3 * rng.standard_normal((H, m.nu, NLANE)), tg)


@pytest.mark.parametrize("name", list(MODELS))
def test_cost_expansion_twin_matches_jax(name):
    make_j, make_p = MODELS[name]
    jt, pt = make_j(), make_p(device="cpu")
    qpos, qvel, U, tg = _states(pt, np.random.default_rng(11))
    got = planes.cost_expansion(pt, *map(torch.from_numpy,
                                         (qpos, qvel, U, tg)))
    # the lane phase routes through the K6 wrapper, which runs this twin
    # for tensors on the CPU
    cfg = planes.ILQRConfig()
    phase = planes.lane_phases(pt, cfg, H)["cost_expansion"]
    ops.reset_launch_counts()
    again = phase(*map(torch.from_numpy, (qpos, qvel, U, tg)))
    assert ops.LAUNCHES["cost_expansion"] == 0
    for g, a in zip(got, again):
        assert torch.equal(g, a)

    jt = jt.replace(keypoint_cfg=jt.keypoint_cfg.replace(
        name="set_interval", min_N=1))
    expansion = jax.jit(make_lane_batch_optimise(
        jt, JConfig(), H).phases["cost_expansion"])
    want = expansion(*map(jnp.asarray, (qpos, qvel, U, tg)))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        scale = float(np.abs(w).max())
        if scale == 0.0:
            assert float(np.abs(g).max()) == 0.0, name
        else:
            assert float(np.abs(g - w).max()) <= REL * scale, (
                name, float(np.abs(g - w).max()) / scale)


def test_reaching_l_uu_stays_exactly_zero():
    """Reaching's residual has no control term (NU = 0 of its seven
    actuators): l_u and l_uu are exactly zero, at terminal weights too."""
    pt = make_reaching(device="cpu")
    qpos, qvel, U, tg = _states(pt, np.random.default_rng(2))
    l_x, l_xx, l_u, l_uu = planes.cost_expansion(
        pt, *map(torch.from_numpy, (qpos, qvel, U, tg)))
    assert l_uu.shape == (H, 7, 7, NLANE) and not bool(l_uu.any())
    assert not bool(l_u.any()) and bool(l_xx.any())


def test_selection_jacobian_maps_coordinates_to_tangent_columns():
    """The walker's rows select rootz and rooty positions, rootx's velocity
    and the six controls: one 1 per row at that coordinate's column."""
    pt = make_walker(run=True, device="cpu")
    J = planes.selection_jacobian(pt)
    n = pt.sv.ndof
    assert J.shape == (9, 2 * n + 6)
    want = torch.zeros_like(J)
    for k, col in enumerate([0, 2, n + 1] + [2 * n + a for a in range(6)]):
        want[k, col] = 1.0
    assert torch.equal(J, want)
