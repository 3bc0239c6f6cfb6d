"""Port step (plain path, batch last) against the JAX generic step and the
JAX lane step, at the 1e-10 bar of tests/test_lanes.py (both sides float64;
the differences are summation order only).

Pentabot's six capsule self-contact pairs are outside this slice (ROADMAP
Queue 1 item 7): both sides run it with `contact_pairs=()`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.dynamics import step_state as jax_step_state
from trajoptkp_tpu.dynamics.fk import forward_kinematics as jax_fk
from trajoptkp_tpu.dynamics.lanes import build_smooth_step
from trajoptkp_tpu.dynamics.model import Data as JData
from trajoptkp_tpu.tasks.toys import make_acrobot, make_pentabot
from trajoptkp_tpu_torch.dynamics.fk import cinert_matrix, forward_kinematics
from trajoptkp_tpu_torch.dynamics.model import Data, load_model
from trajoptkp_tpu_torch.dynamics.step import step_state

jax.config.update("jax_enable_x64", True)

CASES = [("acrobot", make_acrobot), ("pentabot", make_pentabot)]
RTOL, ATOL = 1e-10, 1e-12


def _models(name, make):
    jm = make(dtype=jnp.float64).model.replace(contact_pairs=())
    pm = load_model(name, device="cpu").replace(contact_pairs=())
    return jm, pm


def _states(model, L, seed=0):
    rng = np.random.default_rng(seed)
    qp = rng.standard_normal((model.nq, L))
    qv = 0.5 * rng.standard_normal((model.nv, L))
    ct = 2.0 * rng.standard_normal((model.nu, L))
    return qp, qv, ct


@pytest.mark.parametrize("name,make", CASES)
def test_step_matches_jax_generic_and_lane(name, make):
    jm, pm = _models(name, make)
    qp, qv, ct = _states(jm, 16)
    qp2, qv2 = step_state(pm, torch.from_numpy(qp), torch.from_numpy(qv),
                          torch.from_numpy(ct))
    ref = jax.vmap(lambda a, b, c: jax_step_state(jm, a, b, c),
                   in_axes=1, out_axes=1)(qp, qv, ct)
    lane = jax.jit(build_smooth_step(jm))(jnp.asarray(qp), jnp.asarray(qv),
                                          jnp.asarray(ct))
    for got, want in ((qp2, ref[0]), (qv2, ref[1]), (qp2, lane[0]),
                      (qv2, lane[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,make", CASES)
def test_fk_matches_jax(name, make):
    jm, pm = _models(name, make)
    qp, qv, ct = _states(jm, 1, seed=3)
    d = forward_kinematics(pm, Data(qpos=torch.from_numpy(qp[:, 0]),
                                    qvel=torch.from_numpy(qv[:, 0]),
                                    ctrl=torch.from_numpy(ct[:, 0])))
    jd = jax_fk(jm, JData(qpos=jnp.asarray(qp[:, 0]),
                          qvel=jnp.asarray(qv[:, 0]),
                          ctrl=jnp.asarray(ct[:, 0]), time=jnp.zeros(())))
    d = d.replace(cinert=cinert_matrix(d.cinert))
    for f in ("xpos", "xquat", "xipos", "ximat", "site_xpos", "cdof",
              "cinert"):
        np.testing.assert_allclose(getattr(d, f).numpy(),
                                   np.asarray(getattr(jd, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def test_step_refuses_constraints():
    pm = load_model("pentabot", device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        step_state(pm, torch.zeros(5, 1), torch.zeros(5, 1),
                   torch.zeros(3, 1))
