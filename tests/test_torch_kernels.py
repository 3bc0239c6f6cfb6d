"""The CUDA kernels (with the device functions K1, K2a and K2b inside the
step) and the servo's fk_bias against their plain PyTorch twins on the
card, at small shapes.  They need an NVIDIA GPU with nvcc (sm_90a) and skip
elsewhere; `python3 chip_smoke.py` runs the same checks at the main path's
shapes.  On the card (tests/conftest.py imports JAX, hence --noconftest):
python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

Bars: rollout and line search 1e-10 relative over the first 50 steps
(rounding differences grow along a chaotic horizon), FD columns 1e-6
absolute (rounding divided by 2 eps), backward pass 1e-9 relative, the
cost expansion (K6) and the exact Jacobians (K5ad, with the implicit
constraint tangents K2c inside) bit for bit.
"""

import pytest
import torch

from trajoptkp_tpu_torch.dynamics.contact import (contacts_active,
                                                  limits_active)
from trajoptkp_tpu_torch.kernels import ops
from trajoptkp_tpu_torch.solver import ilqr, lanes
from trajoptkp_tpu_torch.solver.ilqr import ILQRConfig
from trajoptkp_tpu_torch.tasks import pushing
from trajoptkp_tpu_torch.tasks.locomotion import make_walker
from trajoptkp_tpu_torch.tasks.pushing import make_pushing
from trajoptkp_tpu_torch.tasks.reaching import make_reaching
from trajoptkp_tpu_torch.tasks.toys import make_acrobot, make_pentabot

pytestmark = pytest.mark.cuda

H, B = 60, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


@pytest.mark.parametrize("make", [make_acrobot, make_pentabot,
                                  make_reaching])
def test_kernels_match_plain(cuda, make):
    """Reaching starts half its lanes with every joint at a limit, under
    controls of 5 N Nm, so the constraint solve inside the step (K2a) runs
    with active rows; pentabot starts folded, so its capsule pairs touch
    (the contact rows K2b)."""
    task = make(device=cuda)
    task = task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name="set_interval", min_N=3))
    g = torch.Generator(device="cpu").manual_seed(0)
    nv, nu = task.model.nv, task.model.nu
    f64 = dict(dtype=torch.float64)
    qp, qv, tg = lanes.scenes(task, B, seed=1)
    scale = 0.3
    if task.model.contact_pairs:
        # pentabot folded at random (+-3 rad a joint), so its links touch
        qp = (6.0 * torch.rand(qp.shape, generator=g, **f64) - 3.0).to(cuda)
    elif task.model.has_constraints:
        rng = task.model.jnt_range
        side = torch.randint(0, 2, (B // 2, nv), generator=g).to(cuda)
        qp[:B // 2] = torch.where(side == 0, rng[:, 0], rng[:, 1]) + (
            0.01 * torch.randn((B // 2, nv), generator=g, **f64)).to(cuda)
        scale = 5.0
    qp0, qv0, tgl = qp.T.contiguous(), qv.T.contiguous(), tg.T.contiguous()
    U = (scale * torch.randn((H, nu, B), generator=g, **f64)).to(cuda)
    _compare(task, qp0, qv0, tgl, U, g)


def _compare(task, qp0, qv0, tgl, U, g):
    """Each kernel against its twin from these lanes; feedback gains from
    the generator g."""
    cuda = U.device
    f64 = dict(dtype=torch.float64)
    nu, nx = task.model.nu, task.sv.nx
    k = (0.1 * torch.randn((H, nu, B), generator=g, **f64)).to(cuda)
    K = (0.05 * torch.randn((H, nu, nx, B), generator=g, **f64)).to(cuda)
    n = 50

    kr = ops.rollout(task, qp0, qv0, U, tgl)
    pr = ops.rollout(task, qp0, qv0, U, tgl, plain=True)
    for a, b in zip(kr, pr):
        assert _rel(a[:n], b[:n]) < 1e-10
    if task.model.contact_pairs:
        act = contacts_active(task.model, pr[0].transpose(0, 1))
        assert bool(act.any(2).any(1).all()), act.sum((1, 2)).tolist()
    elif task.model.has_constraints:
        assert bool(limits_active(task.model, pr[0].transpose(0, 1)).any())

    cfg = ILQRConfig()
    alphas = ilqr.default_alphas(6, device=cuda)
    kl = ops.linesearch(task, kr[0], kr[1], U, k, K, alphas, tgl)
    pl = ops.linesearch(task, kr[0], kr[1], U, k, K, alphas, tgl, plain=True)
    for a, b in zip(kl, pl):
        assert _rel(a[:n], b[:n]) < 1e-10

    plan = lanes.si_plan(task, H)
    kj = ops.fd_jacobian(task, kr[0], kr[1], U, plan.times, cfg.fd_eps)
    pj = ops.fd_jacobian(task, kr[0], kr[1], U, plan.times, cfg.fd_eps,
                         plain=True)
    assert float((kj - pj).abs().max()) < 1e-6

    fd = lanes.slot_jacobians(task, "fd", eps=cfg.fd_eps)
    A, Bm = lanes.jacobians_si(task, plan, kr[0], kr[1], U, fd)
    l = lanes.cost_expansion(task, kr[0], kr[1], U, tgl)
    lam = torch.full((B,), 0.1, dtype=torch.float64, device=cuda)
    kb = ops.backward(A, Bm, *l, lam, cfg)
    pb = ops.backward(A, Bm, *l, lam, cfg, plain=True)
    live = ~pb[4]                       # a λ-exit lane's gains are not used
    for a, b in zip(kb[:3], pb[:3]):
        assert _rel(a[..., live], b[..., live]) < 1e-9
    assert torch.equal(kb[3], pb[3]) and torch.equal(kb[4], pb[4])


@pytest.mark.parametrize("name", ["acrobot", "pentabot", "reaching",
                                  "push_ncl", "walker"])
def test_cost_expansion_matches_plain(cuda, name):
    """K6 against its twin at random states (push_ncl: its scenes with the
    arm moved), bit for bit, one launch per call."""
    task = {"acrobot": make_acrobot, "pentabot": make_pentabot,
            "reaching": make_reaching, "push_ncl": make_pushing,
            "walker": lambda device: make_walker(run=True, device=device),
            }[name](device=cuda)
    m = task.model
    g = torch.Generator(device="cpu").manual_seed(5)
    f64 = dict(dtype=torch.float64)
    if name == "push_ncl":
        qp, _, tg = pushing.push_scenes(task, B, seed=2)
        qpos = qp.T[None].repeat(H + 1, 1, 1).cpu()
        qpos[:, :7] += 0.1 * torch.randn((H + 1, 7, B), generator=g, **f64)
        tg = tg.T.contiguous()
    else:
        qpos = torch.randn((H + 1, m.nq, B), generator=g, **f64)
        tg = task.residual_targets[:, None].repeat(1, B).contiguous()
    qpos = qpos.to(cuda).contiguous()
    qvel = torch.randn((H + 1, m.nv, B), generator=g, **f64).to(cuda)
    U = torch.randn((H, m.nu, B), generator=g, **f64).to(cuda)
    before = ops.LAUNCHES["cost_expansion"]
    got = ops.cost_expansion(task, qpos, qvel, U, tg)
    assert ops.LAUNCHES["cost_expansion"] == before + 1
    want = ops.cost_expansion(task, qpos, qvel, U, tg, plain=True)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def test_push_kernels_match_plain(cuda):
    """push_ncl (free goal cylinder, 42 constraint rows: the contact rows of
    K2b and the limit rows, solved by K2a inside the step; ndof 10 of nv
    13): half the lanes start with the goal against the pusher rod's lower
    end, a quarter with the arm lowered onto the table, under controls of
    N(0, 2), so that all three pairs touch; the kernels, and with them the
    contact rows K2b inside their step, must equal their twins as above, and
    the instance is push_ncl.  The servo's fk_bias and a few servo steps
    equal their twins as well."""
    task = make_pushing(device=cuda)
    task = task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name="set_interval", min_N=3))
    assert ops.kernel_args(task, task.model.device).tag == "push_ncl"
    m = task.model
    g = torch.Generator(device="cpu").manual_seed(0)
    f64 = dict(dtype=torch.float64)
    qp, qv, tg = pushing.push_scenes(task, B, seed=1)
    qa = m.jnt_qposadr[m.joint_names.index("goal")]
    # the rod's lower end at the start pose is ~(0.353, 0, 0.03)
    qp[:B // 2, qa] = 0.353 + 0.0595
    qp[:B // 2, qa + 1] = 0.0
    qp[B // 2:3 * B // 4, 1] += 0.12
    U = (2.0 * torch.randn((H, m.nu, B), generator=g, **f64)).to(cuda)
    _compare(task, qp.T.contiguous(), qv.T.contiguous(), tg.T.contiguous(),
             U, g)
    # the servo's FK products and bias force (fk_bias) at every state of
    # the rollout
    q, v, _ = ops.rollout(task, qp.T.contiguous(), qv.T.contiguous(), U,
                          tg.T.contiguous(), plain=True)
    q = q.transpose(0, 1).reshape(m.nq, -1).contiguous()
    v = v.transpose(0, 1).reshape(m.nv, -1).contiguous()
    for a, b in zip(ops.fk_bias(task, q, v), ops.fk_bias(task, q, v,
                                                         plain=True)):
        assert _rel(a, b) < 1e-12
    # five setup-servo steps from the scenes, kernels against twins
    qp0, qv0, tgl = (x.T.contiguous() for x in pushing.push_scenes(
        task, B, seed=2))
    path, angle = pushing.setup_path(task, 5, qp0, tgl)
    ks = pushing.servo_along_path(task, path[:5], angle, qp0, qv0, tgl)
    ps = pushing.servo_along_path(task, path[:5], angle, qp0, qv0, tgl,
                                  plain=True)
    for a, b in zip(ks, ps):
        assert _rel(a, b) < 1e-12


def test_wrappers_count_launches_and_check_inputs(cuda):
    task = make_acrobot(device=cuda)
    qp, qv, tg = lanes.scenes(task, 4, seed=0)
    U = torch.zeros((10, 1, 4), dtype=torch.float64, device=cuda)
    ops.reset_launch_counts()
    ops.rollout(task, qp.T.contiguous(), qv.T.contiguous(), U,
                tg.T.contiguous())
    ops.rollout(task, qp.T.contiguous(), qv.T.contiguous(), U,
                tg.T.contiguous(), plain=True)
    assert ops.LAUNCHES["rollout"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        ops.rollout(task, qp.T, qv.T.contiguous(), U, tg.T.contiguous())


def test_walker_kernels_and_mpc_apply_match_plain(cuda):
    """The walker's instance (three joints on the torso, plane-capsule and
    capsule-capsule rows, the selected-coordinate residual) and K8: every
    kernel bit for bit against its twin, with the feet pressed into the
    floor, and one lane-last replan of the kernel path equal to the plain
    path's."""
    from trajoptkp_tpu_torch.mpc import sync as psync
    from trajoptkp_tpu_torch.tasks.locomotion import make_walker

    task = make_walker(run=True, device=cuda)
    m = task.model
    Hw, Bw = 20, 8
    g = torch.Generator(device="cpu").manual_seed(0)
    f64 = dict(dtype=torch.float64)
    qp = task.qpos_start[:, None].repeat(1, Bw)
    qp[0] = (-0.04 * torch.rand(Bw, generator=g, **f64)).to(cuda)
    qp[3:] = (torch.rand((6, Bw), generator=g, **f64) - 0.5).to(cuda)
    qp = qp.contiguous()
    qv = (0.3 * torch.randn((m.nv, Bw), generator=g, **f64)).to(cuda)
    tg = task.residual_targets[:, None].repeat(1, Bw).contiguous()
    U = (2 * torch.rand((Hw, m.nu, Bw), generator=g, **f64) - 1).to(cuda)
    kr = ops.rollout(task, qp, qv, U, tg)
    pr = ops.rollout(task, qp, qv, U, tg, plain=True)
    assert all(torch.equal(a, b) for a, b in zip(kr, pr))
    assert bool(contacts_active(m, pr[0][:Hw].transpose(0, 1))[:7].any())
    times = torch.arange(Hw, device=cuda)
    assert torch.equal(ops.fd_jacobian(task, *kr[:2], U, times, 1e-6),
                       ops.fd_jacobian(task, *kr[:2], U, times, 1e-6,
                                       plain=True))
    accept = torch.arange(Bw, device=cuda) % 2 == 0
    Un = (2 * torch.rand((Hw, m.nu, Bw), generator=g, **f64) - 1).to(cuda)
    z = torch.randn((2, m.nu, Bw), generator=g, **f64).to(cuda)
    std = psync.noise_std(task, 5.0)
    cost = kr[2].sum(0)
    args = (task, qp, qv, U, Un, accept, cost, 2 * cost, z, std, tg)
    before = ops.LAUNCHES["mpc_apply"]
    ka = ops.mpc_apply(*args)
    assert ops.LAUNCHES["mpc_apply"] == before + 1
    pa = ops.mpc_apply(*args, plain=True)
    assert all(torch.equal(a, b) for a, b in zip(ka, pa))
    runs = []
    for plain in (False, True):
        gen = torch.Generator(device=cuda).manual_seed(0)
        mpc = psync.make_lane_sync_mpc(task, ILQRConfig(), 10, 1, 5.0,
                                       plain=plain)
        runs.append(mpc(qp.T, qv.T, torch.zeros((Bw, 10, m.nu), device=cuda,
                                                 **f64), tg.T, 1, gen))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("name", ["adaptive_jerk", "adaptive_accel",
                                  "velocity_change"])
def test_keypoint_kernels_match_plain(cuda, name):
    """K9a (the method's mask and slot plan, also under a slot budget that
    overflows and from a given mask with time slots), K5 at per-lane slots
    and into an iterative_error cache, K9b and K9c, each bit for bit against
    its twin on an acrobot nominal."""
    task = make_acrobot(device=cuda)
    task = task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name=name, min_N=1, max_N=20))
    qp, qv, tg = lanes.scenes(task, B, seed=2)
    g = torch.Generator(device="cpu").manual_seed(1)
    U = (0.5 * torch.randn((H, 1, B), generator=g,
                           dtype=torch.float64)).to(cuda)
    qpos, qvel, _ = ops.rollout(task, qp.T.contiguous(), qv.T.contiguous(),
                                U, tg.T.contiguous())
    pa = ops.keypoint_plan_args(task)
    col = torch.tensor([0, 1, 0, 1, 0], dtype=torch.int32, device=cuda)
    for K_max in (H, 3):
        before = ops.LAUNCHES["keypoint_plan"]
        kp = ops.keypoint_plan(pa, qvel, H, K_max)
        assert ops.LAUNCHES["keypoint_plan"] == before + 1
        pp = ops.keypoint_plan(pa, qvel, H, K_max, plain=True)
        assert all(torch.equal(a, b) for a, b in zip(kp, pp))
        if K_max == 3:
            assert bool((kp.overflow > 0).any())
        kj = ops.fd_jacobian(task, qpos, qvel, U, kp.slot_t, 1e-6,
                             counts=kp.count)
        pj = ops.fd_jacobian(task, qpos, qvel, U, kp.slot_t, 1e-6,
                             counts=kp.count, plain=True)
        assert torch.equal(kj, pj)
        ka = ops.kp_interp(kj, kp.pslot, kp.nslot, kp.w, col, 4)
        pa_ = ops.kp_interp(kj, kp.pslot, kp.nslot, kp.w, col, 4, plain=True)
        assert all(torch.equal(a, b) for a, b in zip(ka, pa_))
    # iterative_error: the cache, K9c, K9a from a mask with time slots
    cache = torch.zeros((H, 4, 5, B), dtype=torch.float64, device=cuda)
    pcache = cache.clone()
    ops.fd_jacobian(task, qpos, qvel, U, kp.slot_t, 1e-6, counts=kp.count,
                    cache=cache)
    ops.fd_jacobian(task, qpos, qvel, U, kp.slot_t, 1e-6, counts=kp.count,
                    cache=pcache, plain=True)
    assert torch.equal(cache, pcache)
    nodes = [torch.tensor(x, dtype=torch.int32, device=cuda)
             for x in ([0, 0, 29], [29, 14, 44], [59, 29, 59])]
    assert torch.equal(ops.ie_mse(cache, *nodes, 2),
                       ops.ie_mse(cache, *nodes, 2, plain=True))
    pm = ops.keypoint_plan_args(task, "mask")
    km = ops.keypoint_plan(pm, qvel, H, H, mask=kp.mask, time_slots=True)
    pmp = ops.keypoint_plan(pm, qvel, H, H, mask=kp.mask, time_slots=True,
                            plain=True)
    assert all(torch.equal(a, b) for a, b in zip(km, pmp))


def _ad_states(name, cuda):
    """(task, qpos (H+1, nq, B), qvel, U (H, nu, B)) of K5ad's check: random
    states with rows active where the model has them (reaching: half the
    lanes at a joint limit; pentabot folded; push_ncl with the goal against
    the rod and the arm on the table; the walker pressed into the floor)."""
    task = {"acrobot": make_acrobot, "pentabot": make_pentabot,
            "reaching": make_reaching, "push_ncl": make_pushing,
            "walker": lambda device: make_walker(run=True, device=device),
            }[name](device=cuda)
    m = task.model
    g = torch.Generator(device="cpu").manual_seed(7)
    f64 = dict(dtype=torch.float64)
    if name == "push_ncl":
        qp, _, _ = pushing.push_scenes(task, B, seed=1)
        qa = m.jnt_qposadr[m.joint_names.index("goal")]
        qp[:B // 2, qa] = 0.353 + 0.0595
        qp[:B // 2, qa + 1] = 0.0
        qp[B // 2:3 * B // 4, 1] += 0.12
        qpos = qp.T.cpu()[None].repeat(H + 1, 1, 1)
        qpos[:, :7] += 0.02 * torch.randn((H + 1, 7, B), generator=g, **f64)
    elif name == "walker":
        qpos = task.qpos_start.cpu()[None, :, None].repeat(H + 1, 1, B)
        qpos[:, 0] = -0.04 * torch.rand((H + 1, B), generator=g, **f64)
        qpos[:, 3:] = torch.rand((H + 1, 6, B), generator=g, **f64) - 0.5
    elif name == "pentabot":
        qpos = 6.0 * torch.rand((H + 1, m.nq, B), generator=g, **f64) - 3.0
    else:
        qpos = (task.qpos_start.cpu()[None, :, None]
                + 0.3 * torch.randn((H + 1, m.nq, B), generator=g, **f64))
        if name == "reaching":
            rng = m.jnt_range.cpu()
            side = torch.randint(0, 2, (H + 1, m.nv, B // 2), generator=g)
            qpos[:, :, :B // 2] = torch.where(
                side == 0, rng[None, :, 0, None], rng[None, :, 1, None]) + \
                0.01 * torch.randn((H + 1, m.nv, B // 2), generator=g, **f64)
    qvel = 0.5 * torch.randn((H + 1, m.nv, B), generator=g, **f64)
    U = 2.0 * torch.randn((H, m.nu, B), generator=g, **f64)
    return (task, qpos.to(cuda).contiguous(), qvel.to(cuda).contiguous(),
            U.to(cuda).contiguous())


@pytest.mark.parametrize("name", ["acrobot", "pentabot", "reaching",
                                  "push_ncl", "walker"])
def test_ad_jacobian_matches_plain(cuda, name):
    """K5ad against its twin (derivs/ad.py, forward mode through the plain
    step with the implicit constraint tangent) bit for bit: at slot times
    shared by every lane, at per-lane slots with live counts (a dead slot
    writes zeros), and scattered into an iterative_error cache; one launch
    per call."""
    task, qpos, qvel, U = _ad_states(name, cuda)
    nx, C = task.sv.nx, task.sv.nx + task.model.nu
    times = torch.arange(0, H, 3, device=cuda)
    before = ops.LAUNCHES["ad_jacobian"]
    kj = ops.ad_jacobian(task, qpos, qvel, U, times)
    assert ops.LAUNCHES["ad_jacobian"] == before + 1
    pj = ops.ad_jacobian(task, qpos, qvel, U, times, plain=True)
    assert bool(torch.isfinite(kj).all()) and torch.equal(kj, pj)
    g = torch.Generator(device="cpu").manual_seed(3)
    K = 6
    slot_t = torch.sort(torch.randint(0, H, (K, B), generator=g),
                        dim=0).values.to(cuda).contiguous()
    counts = torch.randint(1, K + 1, (B,), generator=g,
                           dtype=torch.int32).to(cuda)
    kj = ops.ad_jacobian(task, qpos, qvel, U, slot_t, counts=counts)
    pj = ops.ad_jacobian(task, qpos, qvel, U, slot_t, counts=counts,
                         plain=True)
    assert torch.equal(kj, pj)
    dead = torch.arange(K, device=cuda)[:, None] >= counts[None, :]
    assert not bool(kj.permute(0, 3, 1, 2)[dead].any())
    cache = torch.zeros((H, nx, C, B), dtype=torch.float64, device=cuda)
    pcache = cache.clone()
    ops.ad_jacobian(task, qpos, qvel, U, slot_t, counts=counts, cache=cache)
    ops.ad_jacobian(task, qpos, qvel, U, slot_t, counts=counts,
                    cache=pcache, plain=True)
    assert torch.equal(cache, pcache)


@pytest.mark.parametrize("name", ["box_sweep", "threeD_push"])
def test_box_kernels_match_plain(cuda, name):
    """The box tasks (a free box in the state with its rotations: the
    quaternion rows of K4, K5 and K5ad; plane-box and cylinder-box rows in
    the step): a quarter of the lanes with the box resting flat (its bottom
    corners tie in depth), a quarter tilted 20 degrees, a quarter with the
    box around the pusher's lower end point, 4 mm inside a face, a quarter
    pressed 2 mm into the table, under controls of N(0, 2).  K3, K4, K5,
    K5ad and K6 bit for bit with their twins, K7 at 1e-9; K5ad's and K5's
    libraries are shared by the two tasks (one step instance)."""
    import math

    from trajoptkp_tpu_torch.dynamics.collision import geom_pose
    from trajoptkp_tpu_torch.dynamics.fk import forward_kinematics
    from trajoptkp_tpu_torch.dynamics.model import Data
    from trajoptkp_tpu_torch.kernels import build
    from trajoptkp_tpu_torch.tasks import manipulation

    make = {"box_sweep": manipulation.make_box_sweep,
            "threeD_push": manipulation.make_threed_push}[name]
    task = make(device=cuda)
    task = task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name="set_interval", min_N=3))
    assert ops.kernel_args(task, task.model.device).tag == name
    assert build.step_shared()[name] == "box_sweep"
    m = task.model
    g = torch.Generator(device="cpu").manual_seed(0)
    f64 = dict(dtype=torch.float64)
    qp, qv, tg = manipulation.box_scenes(task, B, seed=1)
    qp, qv, tgl = qp.T.contiguous(), qv.T.contiguous(), tg.T.contiguous()
    qa = m.jnt_qposadr[m.joint_names.index("goal")]
    hx, hz = float(m.geom_size[-1][0]), float(m.geom_size[-1][2])
    a = math.radians(20.0) / 2
    qp[qa + 3:qa + 7, B // 4:B // 2] = torch.tensor(
        [math.cos(a), math.sin(a), 0.0, 0.0], device=cuda, **f64)[:, None]
    q = qp[:, B // 2:3 * B // 4]
    d = forward_kinematics(m, Data(qpos=q, qvel=qv[:, :q.shape[1]],
                                   ctrl=qv[:m.nu, :q.shape[1]]))
    xp, xm = geom_pose(m, d, m.ngeom - 2)          # the pusher
    hl = float(m.geom_size[m.ngeom - 2][1])
    e1, e2 = xp + xm[:, 2] * hl, xp - xm[:, 2] * hl
    e = torch.where((e1[2] < e2[2])[None], e1, e2)
    qp[qa, B // 2:3 * B // 4] = e[0] + hx - 0.004
    qp[qa + 1:qa + 3, B // 2:3 * B // 4] = e[1:]
    qp[qa + 2, 3 * B // 4:] = hz - 0.002
    U = (2.0 * torch.randn((H, m.nu, B), generator=g, **f64)).to(cuda)
    nu, nx = m.nu, task.sv.nx
    k = (0.1 * torch.randn((H, nu, B), generator=g, **f64)).to(cuda)
    K = (0.05 * torch.randn((H, nu, nx, B), generator=g, **f64)).to(cuda)

    kr = ops.rollout(task, qp, qv, U, tgl)
    pr = ops.rollout(task, qp, qv, U, tgl, plain=True)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(kr, pr))
    act = contacts_active(m, pr[0].transpose(0, 1)).any(2).any(1)
    assert bool(act[1]) and bool(act[2]), act.tolist()
    alphas = ilqr.default_alphas(6, device=cuda)
    kl = ops.linesearch(task, kr[0], kr[1], U, k, K, alphas, tgl)
    pl = ops.linesearch(task, kr[0], kr[1], U, k, K, alphas, tgl, plain=True)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(kl, pl))
    plan = lanes.si_plan(task, H)
    for jac in ("fd", "ad"):
        kj = lanes.slot_jacobians(task, jac)(kr[0], kr[1], U, plan.times)
        pj = lanes.slot_jacobians(task, jac, plain=True)(kr[0], kr[1], U,
                                                          plan.times)
        assert bool(torch.isfinite(kj).all()) and torch.equal(kj, pj), jac
    l = ops.cost_expansion(task, kr[0], kr[1], U, tgl)
    pc = ops.cost_expansion(task, kr[0], kr[1], U, tgl, plain=True)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(l, pc))
    A, Bm = lanes.jacobians_si(task, plan, kr[0], kr[1], U,
                               lanes.slot_jacobians(task, "ad"))
    lam = torch.full((B,), 0.1, dtype=torch.float64, device=cuda)
    cfg = ILQRConfig()
    kb = ops.backward(A, Bm, *l, lam, cfg)
    pb = ops.backward(A, Bm, *l, lam, cfg, plain=True)
    live = ~pb[4]
    for a_, b_ in zip(kb[:3], pb[:3]):
        assert _rel(a_[..., live], b_[..., live]) < 1e-9
    assert torch.equal(kb[3], pb[3]) and torch.equal(kb[4], pb[4])


@pytest.mark.parametrize("level", [3, "constrained"])
def test_clutter_kernels_match_plain(cuda, level):
    """push_lcl and push_ccl (one instance, push_lcl's: nv 31, 114 rows,
    nx 38, its loops rolled): the goal and obstacles 1 and 2 pressed into
    each other in a triangle, obstacle 3 into the goal, all 0.5 mm into the
    table, in half the lanes; the other half from the scenes of the task's
    generator, under controls of N(0, 2), at H = 4 (the plain push_lcl
    step is thousands of small launches).  K3, K4, K5, K5ad, K6 and fk_bias
    bit for bit with their twins, K7 at 1e-9 with its λ exactly."""
    import math

    H4, B4 = 4, 8
    task = make_pushing(level, device=cuda)
    task = task.replace(keypoint_cfg=task.keypoint_cfg.replace(
        name="set_interval", min_N=1))
    assert ops.kernel_args(task, task.model.device).tag == "push_lcl"
    m = task.model
    qp, qv, tg = (x.T.contiguous() for x in pushing.push_scenes(task, B4,
                                                               seed=1))
    qa = [m.jnt_qposadr[m.joint_names.index(b)]
          for b in ("goal", "obstacle_1", "obstacle_2", "obstacle_3")]
    d = 2 * pushing.OBJECT_R - 0.0005
    tri = [(0.5, 0.0), (0.5 + d, 0.0), (0.5 + d / 2, d * math.sqrt(0.75))]
    for a, (x, y) in zip(qa, tri + [(0.5 - d, 0.0)]):
        qp[a, B4 // 2:], qp[a + 1, B4 // 2:] = x, y
        qp[a + 2, B4 // 2:] = pushing.OBJECT_Z - 0.0025
    g = torch.Generator(device="cpu").manual_seed(0)
    f64 = dict(dtype=torch.float64)
    nu, nx = m.nu, task.sv.nx
    U = (2.0 * torch.randn((H4, nu, B4), generator=g, **f64)).to(cuda)
    k = (0.1 * torch.randn((H4, nu, B4), generator=g, **f64)).to(cuda)
    K = (0.05 * torch.randn((H4, nu, nx, B4), generator=g, **f64)).to(cuda)
    kr = ops.rollout(task, qp, qv, U, tg)
    pr = ops.rollout(task, qp, qv, U, tg, plain=True)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(kr, pr))
    act = contacts_active(m, pr[0].transpose(0, 1)).any(2).any(1)
    assert int(act.sum()) >= 9, act.tolist()
    alphas = ilqr.default_alphas(6, device=cuda)
    kl = ops.linesearch(task, kr[0], kr[1], U, k, K, alphas, tg)
    pl = ops.linesearch(task, kr[0], kr[1], U, k, K, alphas, tg, plain=True)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(kl, pl))
    plan = lanes.si_plan(task, H4)
    for jac in ("fd", "ad"):
        kj = lanes.slot_jacobians(task, jac)(kr[0], kr[1], U, plan.times)
        pj = lanes.slot_jacobians(task, jac, plain=True)(kr[0], kr[1], U,
                                                          plan.times)
        assert bool(torch.isfinite(kj).all()) and torch.equal(kj, pj), jac
    l = ops.cost_expansion(task, kr[0], kr[1], U, tg)
    pc = ops.cost_expansion(task, kr[0], kr[1], U, tg, plain=True)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(l, pc))
    A, Bm = lanes.jacobians_si(task, plan, kr[0], kr[1], U,
                               lanes.slot_jacobians(task, "ad"))
    lam = torch.full((B4,), 0.1, dtype=torch.float64, device=cuda)
    cfg = ILQRConfig()
    kb = ops.backward(A, Bm, *l, lam, cfg)
    pb = ops.backward(A, Bm, *l, lam, cfg, plain=True)
    live = ~pb[4]
    for a_, b_ in zip(kb[:3], pb[:3]):
        assert _rel(a_[..., live], b_[..., live]) < 1e-9
    assert torch.equal(kb[3], pb[3]) and torch.equal(kb[4], pb[4])
    kf = ops.fk_bias(task, qp, qv)
    pf = ops.fk_bias(task, qp, qv, plain=True)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(kf, pf))
