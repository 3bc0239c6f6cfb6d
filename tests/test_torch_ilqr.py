"""Port iLQR pieces (plain path, B lanes, batch last) against the JAX
generic solver per scene (`trajoptkp_tpu/solver/ilqr.py:150,380,414`), at
1e-10 relative in float64 (summation order is the only difference).

Pentabot runs contact-free on both sides (its self-contacts are ROADMAP
Queue 1 item 7); its nu = 3 exercises the Cholesky of the backward pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.solver import ilqr as jilqr
from trajoptkp_tpu.tasks import toys as jtoys
from trajoptkp_tpu_torch.solver import ilqr as pilqr
from trajoptkp_tpu_torch.solver import lanes as planes
from trajoptkp_tpu_torch.tasks import toys as ptoys

jax.config.update("jax_enable_x64", True)

RTOL, ATOL = 1e-10, 1e-12
H, NLANE = 25, 3


def _tasks(name):
    jt = getattr(jtoys, f"make_{name}")(dtype=jnp.float64)
    jt = jt.replace(model=jt.model.replace(contact_pairs=()))
    pt = getattr(ptoys, f"make_{name}")(device="cpu")
    return jt, pt


def _scenes(pt, seed):
    rng = np.random.default_rng(seed)
    nq, nu = pt.model.nq, pt.model.nu
    qp = pt.qpos_start.numpy()[:, None] + 0.3 * rng.standard_normal((nq, NLANE))
    qv = 0.2 * rng.standard_normal((nq, NLANE))
    U = 0.5 * rng.standard_normal((H, nu, NLANE))
    tg = np.repeat(pt.residual_targets.numpy()[:, None], NLANE, axis=1)
    return qp, qv, U, tg


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("name", ["acrobot", "pentabot"])
def test_rollout_matches_jax(name):
    jt, pt = _tasks(name)
    qp, qv, U, tg = _scenes(pt, 0)
    qpos, qvel, costs = pilqr.rollout(pt, *map(torch.from_numpy, (qp, qv, U, tg)))
    for b in range(NLANE):
        ref = jilqr.rollout(jt, qp[:, b], qv[:, b], U[:, :, b])
        _close(qpos[..., b], ref.qpos, "qpos")
        _close(qvel[..., b], ref.qvel, "qvel")
        _close(costs[:, b], ref.costs, "costs")


def _bp_inputs(n2, nu, seed):
    """Random well-posed expansions; lane 0 has an indefinite l_uu so its
    sweep fails at small λ and retries, the other lanes need no retry."""
    rng = np.random.default_rng(seed)
    A = np.eye(n2)[None, :, :, None] + 0.05 * rng.standard_normal((H, n2, n2, NLANE))
    Bm = 0.1 * rng.standard_normal((H, n2, nu, NLANE))
    l_x = rng.standard_normal((H, n2, NLANE))
    R = rng.standard_normal((H, n2, n2, NLANE))
    l_xx = np.einsum("hijb,hkjb->hikb", R, R) / n2
    l_u = rng.standard_normal((H, nu, NLANE))
    S = rng.standard_normal((H, nu, nu, NLANE))
    l_uu = np.einsum("hijb,hkjb->hikb", S, S) / nu + 0.5 * np.eye(nu)[None, :, :, None]
    l_uu[:, :, :, 0] -= 0.9 * np.eye(nu) * (np.abs(l_uu[:, :, :, 0]).sum() / H)
    return A, Bm, l_x, l_xx, l_u, l_uu


@pytest.mark.parametrize("nx,nu", [(4, 1), (10, 3)])
def test_backward_pass_lambda_loop_matches_jax(nx, nu):
    """One scene at a time (B = 1, the generic solve's batch), the port's
    loop is the JAX generic `backward_pass_lambda_loop`, the retrying scene
    included."""
    ins = _bp_inputs(nx, nu, seed=nx)
    lamb = np.full(NLANE, 0.1)
    cfg = pilqr.ILQRConfig()
    jcfg = jilqr.ILQRConfig()
    retried = 0
    for b in range(NLANE):
        k, K, dJ, lam, ex = pilqr.backward_pass_lambda_loop(
            *(torch.from_numpy(x[..., b:b + 1]) for x in ins),
            torch.from_numpy(lamb[b:b + 1]), cfg)
        k, K, dJ, lam, ex = k[..., 0], K[..., 0], dJ[0], lam[0], ex[0]
        jk, jK, jdJ, jlam, jex = jilqr.backward_pass_lambda_loop(
            *(x[..., b] for x in ins), jnp.asarray(lamb[b]), jcfg)
        assert bool(ex) == bool(jex)
        _close(lam, jlam, "lambda")
        retried += float(jlam) > 0.1 / 10 + 1e-15
        if not bool(jex):
            _close(k, jk, "k")
            _close(K, jK, "K")
            _close(dJ, jdJ, "dJ")
    assert retried >= 1  # the indefinite lane went through the λ retry


@pytest.mark.parametrize("nx,nu", [(4, 1), (20, 7)])
def test_backward_pass_sum_order_matches_jax(nx, nu):
    """The reference order (`sum_contract`, torch's reductions) against the
    JAX sweep as above, and against the kernel order at 1e-12 relative:
    the orders differ by rounding only."""
    ins = _bp_inputs(nx, nu, seed=nx + 1)
    lamb = torch.full((NLANE,), 0.1, dtype=torch.float64)
    cfg = pilqr.ILQRConfig()
    ref = pilqr.backward_pass_lambda_loop(*map(torch.from_numpy, ins), lamb,
                                          cfg, contract=pilqr.sum_contract)
    got = pilqr.backward_pass_lambda_loop(*map(torch.from_numpy, ins), lamb,
                                          cfg)
    assert torch.equal(ref[3], got[3]) and torch.equal(ref[4], got[4])
    live = ~ref[4]
    for a, b in zip(got[:3], ref[:3]):
        a, b = a[..., live], b[..., live]
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    jcfg = jilqr.ILQRConfig()
    for b in range(NLANE):
        # one scene at a time, as the JAX generic loop runs it
        one = pilqr.backward_pass_lambda_loop(
            *(torch.from_numpy(x[..., b:b + 1]) for x in ins), lamb[b:b + 1],
            cfg, contract=pilqr.sum_contract)
        jk, jK, jdJ, _, jex = jilqr.backward_pass_lambda_loop(
            *(x[..., b] for x in ins), jnp.asarray(0.1), jcfg)
        assert bool(one[4][0]) == bool(jex)
        if bool(jex):
            continue
        _close(one[0][..., 0], jk, "k")
        _close(one[1][..., 0], jK, "K")
        _close(one[2][0], jdJ, "dJ")


@pytest.mark.parametrize("name", ["acrobot", "pentabot"])
def test_line_search_matches_jax(name):
    jt, pt = _tasks(name)
    qp, qv, U, tg = _scenes(pt, 1)
    n2, nu = 2 * pt.model.nv, pt.model.nu
    rng = np.random.default_rng(2)
    k = 0.3 * rng.standard_normal((H, nu, NLANE))
    K = 0.2 * rng.standard_normal((H, nu, n2, NLANE))
    qpos, qvel, costs = pilqr.rollout(pt, *map(torch.from_numpy, (qp, qv, U, tg)))
    old = costs.sum(0) * torch.tensor([1.0, 1e-3, 10.0])  # reject lane 1
    alphas = pilqr.default_alphas(6)
    (bq, bv, bu, bc), best, best_cost, accept = planes.forward_pass(
        pt, qpos, qvel, torch.from_numpy(U), torch.from_numpy(k),
        torch.from_numpy(K), alphas, torch.from_numpy(tg), old)
    assert not bool(accept[1])
    for b in range(NLANE):
        traj = jilqr.Trajectory(jnp.asarray(qpos[..., b].numpy()),
                                jnp.asarray(qvel[..., b].numpy()),
                                jnp.asarray(U[:, :, b]),
                                jnp.asarray(costs[:, b].numpy()))
        jnew, jcost, jacc, jalpha = jilqr.forward_pass(
            jt, traj, jnp.asarray(k[..., b]), jnp.asarray(K[..., b]),
            jilqr.default_alphas(6),
            float(old[b]))
        assert bool(accept[b]) == bool(jacc)
        _close(alphas[best[b]], jalpha, "alpha")
        if bool(jacc):
            _close(best_cost[b], jcost, "cost")
            _close(bq[..., b], jnew.qpos, "qpos")
            _close(bv[..., b], jnew.qvel, "qvel")
            _close(bu[..., b], jnew.ctrl, "ctrl")
            _close(bc[:, b], jnew.costs, "costs")


def test_lambda_retry_is_per_lane_unlike_the_coupled_jax_batch():
    """The λ retry of the port's backward pass (twin of K7) against the JAX
    lane solver's `bp_lambda_loop` (`solver/lanes.py:720-746`), on crafted
    inputs where one lane is indefinite at small λ.  (The port retried per
    lane until it took the JAX batch's coupled rule; the name stayed.)

    As one batch both loops sweep every lane again while any lane is
    invalid and not exited, so the λ of the lanes valid at once falls a
    second time: λ, exit flags and gains agree for every lane, and the
    twin reports the retry rounds.  Run one lane at a time, there is
    nothing to couple to, and the two agree again."""
    from trajoptkp_tpu.solver import lanes as jlanes

    jt, _ = _tasks("acrobot")
    jt = jt.replace(keypoint_cfg=jt.keypoint_cfg.replace(
        name="set_interval", min_N=1))
    jcfg = jilqr.ILQRConfig()
    bp = jax.jit(jlanes.make_lane_batch_optimise(jt, jcfg, H).phases["bp"])
    ins = _bp_inputs(4, 1, seed=4)
    lamb = np.full(NLANE, 0.1)
    info = {}
    k, K, dJ, lam, ex = pilqr.backward_pass_lambda_loop(
        *map(torch.from_numpy, ins), torch.from_numpy(lamb),
        pilqr.ILQRConfig(), info=info)
    jk, jK, jdJ, jlam, jex = (np.asarray(x) for x in bp(*ins,
                                                        jnp.asarray(lamb)))
    assert not jex.any() and not bool(ex.any())
    _close(lam, jlam, "lambda")
    _close(k, jk, "k")
    _close(K, jK, "K")
    _close(dJ, jdJ, "dJ")
    assert int(info["rounds"]) >= 1
    # the coupling: lanes 1 and 2, valid at once, end below λ0 / 10
    assert float(lam[0]) > 0.1 / 10 + 1e-15
    assert (lam[1:].numpy() < 0.1 / 10 * 0.5).all(), lam
    for b in range(NLANE):
        k1, K1, dJ1, lam1, ex1 = pilqr.backward_pass_lambda_loop(
            *(torch.from_numpy(x[..., b:b + 1]) for x in ins),
            torch.from_numpy(lamb[b:b + 1]), pilqr.ILQRConfig())
        jk, jK, jdJ, jlam, jex = bp(*(x[..., b:b + 1] for x in ins),
                                    jnp.asarray(lamb[b:b + 1]))
        assert bool(ex1[0]) == bool(jex[0])
        _close(lam1, jlam, "lambda")
        _close(k1, jk, "k")
        _close(K1, jK, "K")
        _close(dJ1, jdJ, "dJ")
