"""K7's launch geometry (kernels/ops.py:backward_geometry: block size,
lanes per block, dynamic shared memory), in pure Python,
at every backward-pass instance of kernels/csrc/instances.cuh and at the
state sizes the moderate-clutter tasks bring (nx 50 and 62, nu 7); and the
kernel against its plain twin on the card, bit for bit, at B = 1, 3, 64
and 130 with λ retries and λ-exits.  The card's test skips elsewhere; run
it there with
python -m pytest tests/test_torch_backward_layout.py -m cuda --noconftest
"""

import math
import re

import numpy as np
import pytest
import torch

from trajoptkp_tpu_torch.bench_kernels import (backward_inputs,
                                               cpu_sqrt_off_share,
                                               exact_cpu_sqrt)
from trajoptkp_tpu_torch.kernels import build, ops
from trajoptkp_tpu_torch.solver import ilqr
from trajoptkp_tpu_torch.utils import linalg

SHAPES = sorted(ops.backward_instances()) + [(50, 7), (62, 7)]
LANE_COUNTS = (1, 3, 4, 5, 64, 130, 512)


@pytest.mark.parametrize("nx,nu", SHAPES)
def test_geometry_fits_a_block(nx, nu):
    """Every shape fits the 227 KB a block may take, with its two input
    buffers, in 128 to 512 threads; a warp per lane up to nx 10, a block
    past it."""
    g = ops.backward_geometry(nx, nu)
    assert g.smem_bytes <= ops.SMEM_LIMIT == 227 * 1024
    assert g.smem_bytes == ops.backward_smem_bytes(nx, nu, g.lanes)
    assert ops.BP_THREADS[0] <= g.threads <= ops.BP_THREADS[1]
    assert g.threads % 32 == 0
    if nx <= ops.BP_WARP_NX:
        assert g.threads == 32 * g.lanes and g.lanes > 1
    else:
        assert g.lanes == 1
        # the solving warps and at least one warp that loads meanwhile
        assert g.threads >= ops.backward_solver_threads(nx) + 32
        # about two entries of the widest phase per thread, or the most
        # threads a block takes
        widest = max(ops.backward_phase_entries(nx, nu))
        assert g.threads == ops.BP_THREADS[1] or widest <= 2 * g.threads


@pytest.mark.parametrize("nx,nu", SHAPES)
def test_geometry_covers_every_lane_once(nx, nu):
    """The blocks of a launch give each lane 0..B-1 one group of
    threads / lanes threads, in one block, and no thread a lane twice."""
    g = ops.backward_geometry(nx, nu)
    group = g.threads // g.lanes
    for B in LANE_COUNTS:
        owners = {}
        for block in range(g.blocks(B)):
            for thread in range(g.threads):
                b = g.lane(block, thread)
                if b < B:
                    owners.setdefault(b, set()).add((block, thread))
        assert sorted(owners) == list(range(B))
        for threads in owners.values():
            assert len(threads) == group
            assert len({blk for blk, _ in threads}) == 1
        # the last block holds at least one lane
        assert (g.blocks(B) - 1) * g.lanes < B <= g.blocks(B) * g.lanes


def _layout_doubles(nx, nu):
    """(lane, pairs) of csrc/backward.cu:BpLayout, in doubles and pairs,
    evaluated from the struct's own constexpr lines."""
    text = (build.CSRC / "backward.cu").read_text()
    body = text[text.index("struct BpLayout"):text.index("};",
                                                         text.index(
                                                             "struct BpLayout"))]
    env = {"NX": nx, "NU": nu}
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);",
                                 body):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env["LANE"], env["NPAIR"]


@pytest.mark.parametrize("nx,nu", SHAPES)
def test_shared_memory_mirrors_the_kernel_layout(nx, nu):
    """backward_smem_bytes counts what BpLayout lays out (the C entry
    refuses any other byte count on the card)."""
    lane, npair = _layout_doubles(nx, nu)
    for lanes in (1, 4):
        want = (8 * lanes * lane + 2 * npair + 15) // 16 * 16
        assert ops.backward_smem_bytes(nx, nu, lanes) == want


@pytest.mark.parametrize("nx,nu", [(70, 7), (64, 20)])
def test_geometry_refuses_what_a_block_cannot_hold(nx, nu):
    """A lane whose work arrays and two input buffers pass the 227 KB a
    block may take is refused, naming its bytes; the kernel has no
    single-buffered layout to fall back on."""
    need = ops.backward_smem_bytes(nx, nu, 1)
    assert need > ops.SMEM_LIMIT
    with pytest.raises(NotImplementedError, match=f"needs {need} bytes"):
        ops.backward_geometry(nx, nu)


def test_retry_inputs_take_every_round():
    """The inputs the card's test and chip_smoke.py hold K7 on make the
    coupled λ loop retry through all its rounds: a λ-exit in every fourth
    lane, finite gains where l_uu is positive definite, and a lane that
    ends invalid without exiting (its λ fell back below 0.5)."""
    cfg = ilqr.ILQRConfig()
    inputs = backward_inputs(10, 3, 8, 9, seed=2, device="cpu",
                             retries=True)
    info = {}
    k, K, dJ, lam, exit_ = ops.backward(*inputs, cfg, info=info)
    assert int(info["rounds"]) == ilqr.bp_rounds(cfg)
    assert exit_.tolist() == [b % 4 == 3 for b in range(9)]
    pd = torch.arange(9) % 4 == 0
    assert bool(torch.isfinite(k[..., pd]).all())
    assert bool(torch.isfinite(K[..., pd]).all())
    assert bool(torch.isfinite(dJ[pd]).all())
    assert not bool(torch.isfinite(k[..., ~exit_]).all())


def test_exact_cpu_sqrt_rounds_correctly():
    """Inside exact_cpu_sqrt the twins' Cholesky takes the correctly
    rounded square root (Python's math.sqrt, IEEE) of every double; torch's
    own CPU sqrt is at most an ulp from it, and the share it rounds
    otherwise is what cpu_sqrt_off_share counts.  Outside, nothing is
    replaced."""
    x = np.random.default_rng(0).random(100_000) * np.repeat(
        [1e-6, 1.0, 1e3, 1e9], 25_000)
    exact = np.array([math.sqrt(v) for v in x])
    with exact_cpu_sqrt():
        assert linalg.torch is not torch
        ours = linalg.torch.sqrt(torch.from_numpy(x)).numpy()
    assert linalg.torch is torch
    assert np.array_equal(ours, exact)
    theirs = torch.sqrt(torch.from_numpy(x)).numpy()
    assert bool((np.abs(theirs - exact) <= np.spacing(exact)).all())
    off = float((theirs != exact).mean())
    assert 0.0 <= cpu_sqrt_off_share() <= 0.05 and off <= 0.05


def test_exact_sqrt_twin_stays_by_the_twin():
    """The kernel-order twin with the exact square root (order_witness's
    CPU run) lands within rounding of the plain twin: λ and λ-exit equal,
    k, K and dJ NaN at the same entries and else within 1e-12 where no
    lane λ-exits."""
    cfg = ilqr.ILQRConfig()
    inputs = backward_inputs(14, 7, 20, 64, seed=3, device="cpu",
                             retries=True)
    plain = ilqr.backward_pass_lambda_loop(*inputs, cfg)
    with exact_cpu_sqrt():
        exact = ilqr.backward_pass_lambda_loop(*inputs, cfg)
    assert torch.equal(plain[3], exact[3]) and torch.equal(plain[4],
                                                           exact[4])
    run = ~plain[4]
    for a, b in zip(plain[:3], exact[:3]):
        a, b = a[..., run], b[..., run]
        assert torch.equal(a.isnan(), b.isnan())
        a, b = a[~a.isnan()], b[~b.isnan()]
        assert a.numel() and float((a - b).abs().max()
                                   / b.abs().max()) < 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    """Equal element for element, NaN where the other is NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B", (1, 3, 64, 130))
def test_kernel_matches_twin_bit_for_bit(cuda, B):
    """K7 against backward_pass_lambda_loop at every built instance: k, K,
    dJ, λ and λ-exit equal, NaN gains of λ-exit lanes included."""
    cfg = ilqr.ILQRConfig()
    for nx, nu in sorted(ops.backward_instances()):
        inputs = backward_inputs(nx, nu, 10, B, seed=nx + B, device=cuda,
                                 retries=True)
        kb = ops.backward(*inputs, cfg)
        pb = ops.backward(*inputs, cfg, plain=True)
        for name, a, b in zip(("k", "K", "dJ", "λ", "λ-exit"), kb, pb):
            assert _same(a, b), f"nx {nx} nu {nu} B {B}: {name} differs"


@pytest.mark.cuda
@pytest.mark.parametrize("threads", (64, 256, 512))
def test_kernel_matches_twin_at_other_block_sizes(cuda, threads):
    """K7 with a block size other than backward_geometry's (where a block
    owns a lane and the size fits the kernel) equals the twin bit for bit:
    the geometry moves no sum."""
    cfg = ilqr.ILQRConfig()
    for nx, nu in sorted(ops.backward_instances()):
        g = ops.backward_geometry(nx, nu)
        if g.lanes != 1 or threads < ops.backward_solver_threads(nx) + 32:
            continue
        inputs = backward_inputs(nx, nu, 10, 6, seed=nx, device=cuda,
                                 retries=True)
        kb = ops.backward(*inputs, cfg, geometry=g._replace(threads=threads))
        pb = ops.backward(*inputs, cfg, plain=True)
        for name, a, b in zip(("k", "K", "dJ", "λ", "λ-exit"), kb, pb):
            assert _same(a, b), f"nx {nx} threads {threads}: {name} differs"
