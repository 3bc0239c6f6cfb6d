"""K4's and K5ad's launch plans (kernels/ops.py: linesearch_geometry,
ad_primal_entries, ad_chunk) in pure Python, at every model instance of
kernels/csrc/instances.cuh and at the sizes of the moderate-clutter pushing
task (nv 55, 45 contact pairs, nx 62); the plans' byte counts against the
C++ structs they mirror (csrc/warp_step.cuh:WarpLayout,
csrc/constraint.cuh:AdLayout), and the warp-per-lane line search against
the one-thread line search bit for bit, both compiled by the host's g++
with a stub CUDA runtime (one std::thread per CUDA thread, a std::barrier
per warp for __syncwarp and __shfl_sync, one per block for
__syncthreads); and on the card both kernels against their
plain twins.  The card's tests skip elsewhere; run them there with
python -m pytest tests/test_torch_step_layout.py -m cuda --noconftest
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from trajoptkp_tpu_torch.config.loader import make_task
from trajoptkp_tpu_torch.kernels import build, ops
from trajoptkp_tpu_torch.kernels.topology import Topology
from trajoptkp_tpu_torch.solver import ilqr, lanes

TABLES = build.instance_tables()
TASKS = {"acrobot": "acrobot", "pentabot": "pentabot",
         "reaching": "reaching", "push_ncl": "pushing_no_clutter",
         "walker": "walker_run", "box_sweep": "box_sweep",
         "threeD_push": "threeD_push", "push_lcl": "pushing_low_clutter"}
ALPHAS = 6
SCENES = (1, 3, 5, 128, 130)


def moderate_clutter() -> Topology:
    """push_lcl's tables grown to the moderate-clutter task's eight free
    objects (the goal and seven obstacles): nv 55, the 45 pairs of each
    object with the table, the pusher and every other object, and the
    pusher with the table; the state the arm and each object's
    translation (nx 62)."""
    t = TABLES["push_lcl"]
    objs = [b for b in range(t.NBODY) if t.FREE[b]]
    last = objs[-1]
    parent, bdof, bnd, bq, free = (list(x) for x in (
        t.PARENT, t.BODY_DOF, t.BODY_NDOF, t.BODY_QADR, t.FREE))
    slide, lim, dbody, dq, sv = (list(x) for x in (
        t.SLIDE, t.LIMITED, t.DOF_BODY, t.DOF_Q, t.SV))
    nv, nq = t.NV, t.NV + len(objs)
    for _ in range(4):
        b = len(parent)
        parent.append(0)
        bdof.append(nv)
        bnd.append(6)
        bq.append(nq)
        free.append(1)
        for k in range(6):
            slide.append(0)
            lim.append(0)
            dbody.append(b)
            dq.append(nq + k)
        sv += [nv, nv + 1, nv + 2]
        objs.append(b)
        nv += 6
        nq += 7
    plane = next(p for p in t.PAIRS if p[2] == 0 and p[3] == last)
    pusher = next(p for p in t.PAIRS if p[3] == last and p[2] != 0
                  and p[2] not in objs)
    table_pusher = next(p for p in t.PAIRS if p[2] == 0
                        and p[3] not in objs)
    cyl = next(p for p in t.PAIRS if p[2] in objs and p[3] in objs)
    pairs = [table_pusher]
    pairs += [(plane[0], plane[1], 0, o) for o in objs]
    pairs += [(pusher[0], pusher[1], pusher[2], o) for o in objs]
    pairs += [(cyl[0], cyl[1], a, b) for i, a in enumerate(objs)
              for b in objs[i + 1:]]
    resargs = t.RESARGS[:2] + tuple(objs[1:])
    return t._replace(NV=nv, NBODY=len(parent), NDOF=len(sv),
                      PARENT=tuple(parent), BODY_DOF=tuple(bdof),
                      BODY_NDOF=tuple(bnd), BODY_QADR=tuple(bq),
                      FREE=tuple(free), SLIDE=tuple(slide),
                      LIMITED=tuple(lim), DOF_BODY=tuple(dbody),
                      DOF_Q=tuple(dq), SV=tuple(sv), PAIRS=tuple(pairs),
                      RESARGS=resargs)


TOPOS = dict(TABLES, push_mcl=moderate_clutter())


def test_moderate_clutter_sizes():
    """The stand-in for the moderate-clutter task has its sizes."""
    t = TOPOS["push_mcl"]
    assert (t.NV, len(t.PAIRS), 2 * t.NDOF, t.NU) == (55, 45, 62, 7)


def test_moderate_clutter_lanes_fit_but_wait_on_two_rows_a_thread():
    """At the moderate-clutter sizes a lane's arrays (61.5 KB) and the
    tables fit a block three lanes at a time, one block an SM: 396
    resident lanes of 768 at B = 128, two waves; the cooperative step's
    factor holds a row of M a thread, so its 55 dofs are refused until it
    holds two."""
    t = TOPOS["push_mcl"]
    per_lane = 8 * ops.linesearch_lane_doubles(t)
    lanes = (ops.SMEM_LIMIT - ops.warp_tables_bytes(t)) // per_lane
    assert lanes == 3
    smem = per_lane * lanes + ops.warp_tables_bytes(t) + 1024
    assert ops.SMEM_PER_SM // smem == 1
    assert -(-ALPHAS * 128 // (ops.NUM_SMS * lanes)) == 2
    with pytest.raises(NotImplementedError, match="up to 32 dofs, not 55"):
        ops.linesearch_geometry(t, ALPHAS, 128)


@pytest.mark.parametrize("tag", sorted(TABLES))
def test_linesearch_geometry_fits_a_block(tag):
    """A warp per lane with constraint rows, at most LS_MAX_LANES lanes
    and 227 KB a block with the tables; a thread per lane in blocks of 64
    without rows; B = 128 scenes of six alphas take one block of six lanes
    per SM, one wave on 132 SMs."""
    t = TOPOS[tag]
    for B in SCENES:
        g = ops.linesearch_geometry(t, ALPHAS, B)
        assert g.smem_bytes + (ops.warp_tables_bytes(t) if g.warp else 0) \
            <= ops.SMEM_LIMIT == 227 * 1024
        if ops.step_sizes(t).rows == 0:
            assert (g.threads, g.lanes, g.smem_bytes, g.warp) == (
                64, 64, 0, False)
            continue
        assert g.warp and g.threads == 32 * g.lanes
        assert 1 <= g.lanes <= ops.LS_MAX_LANES
        assert g.smem_bytes == 8 * ops.linesearch_lane_doubles(t) * g.lanes
        assert g.blocks_per_sm >= 1
        if B == 128:
            assert g.lanes == min(ALPHAS, (
                ops.SMEM_LIMIT - ops.warp_tables_bytes(t)) // (
                8 * ops.linesearch_lane_doubles(t)))
            resident = ops.NUM_SMS * g.blocks_per_sm * g.lanes
            assert g.waves(ALPHAS, B) == -(-ALPHAS * B // resident) == 1


@pytest.mark.parametrize("tag", sorted(TABLES))
def test_linesearch_plan_covers_every_lane_once(tag):
    """The launch gives each (alpha, scene) one warp (or one thread), in
    one block, and the last block holds a lane; also where a block's
    lanes do not divide A B (four lanes a block at odd B)."""
    t = TOPOS[tag]
    for B in SCENES:
        g0 = ops.linesearch_geometry(t, ALPHAS, B)
        plans = [g0]
        if g0.warp:
            plans.append(g0._replace(lanes=4, threads=128,
                                     smem_bytes=g0.smem_bytes // g0.lanes
                                     * 4))
        for g in plans:
            per = 32 if g.warp else 1
            owners = {}
            for block in range(g.blocks(ALPHAS, B)):
                for thread in range(g.threads):
                    a, b = g.lane(block, thread, ALPHAS)
                    if b < B:
                        owners.setdefault((a, b), set()).add((block, thread))
            assert sorted(owners) == [(a, b) for a in range(ALPHAS)
                                      for b in range(B)]
            for threads in owners.values():
                assert len(threads) == per
                assert len({blk for blk, _ in threads}) == 1
            n = ALPHAS * B
            assert (g.blocks(ALPHAS, B) - 1) * g.lanes < n <= \
                g.blocks(ALPHAS, B) * g.lanes


def test_linesearch_refuses_a_lane_past_a_block():
    """A lane whose arrays pass the 227 KB a block may take is refused,
    naming its bytes."""
    t = TABLES["push_lcl"]
    big = t._replace(PAIRS=t.PAIRS * 30)
    need = 8 * ops.linesearch_lane_doubles(big)
    assert need + ops.warp_tables_bytes(big) > ops.SMEM_LIMIT
    with pytest.raises(NotImplementedError, match=f"needs {need} bytes"):
        ops.linesearch_geometry(big, ALPHAS, 128)


def _ad_threads(K, B, nc, chunk, counts=None):
    """(slot, column, scene) -> (chunk, thread) of K5ad's tangent pass, as
    the C entry's chunk loop and csrc/ad_jacobian.cu:ad_jacobian_kernel
    decompose them; and (slot, scene) -> chunk of the primal pass, for the
    live slots."""
    tangent, primal = {}, {}
    if chunk == 0:       # one pass: no primal entries
        for idx in range(K * nc * B):
            b, sc = idx % B, idx // B
            tangent.setdefault((sc // nc, sc % nc, b), []).append((0, idx))
        return tangent, primal
    for s0 in range(0, K, chunk):
        n = min(chunk, K - s0)
        for idx in range(n * nc * B):
            b, sc = idx % B, idx // B
            c, s = sc % nc, s0 + sc // nc
            tangent.setdefault((s, c, b), []).append((s0, idx))
        for idx in range(n * B):
            b, s = idx % B, s0 + idx // B
            if counts is None or s < counts[b]:
                primal.setdefault((s, b), []).append(s0)
    return tangent, primal


@pytest.mark.parametrize("tag", sorted(TOPOS))
def test_ad_plan_covers_every_slot_column_and_lane(tag):
    """Every (slot, column, scene) has one tangent thread, dead slots
    included (they write zeros or, scattered, nothing), and every live
    (slot, scene) one primal thread, in the chunk that holds its slot,
    whatever the chunk; the primal buffer of a chunk stays under the
    wrapper's cap and holds AdLayout's entries."""
    t = TOPOS[tag]
    nc = 2 * t.NDOF + t.NU
    entries = ops.ad_primal_entries(t)
    z = ops.step_sizes(t)
    want = ((t.NV + t.NV * (t.NV + 1) // 2) if z.rows else 0) + (
        z.nq if z.has_rot else 0)
    assert entries == want
    for K, B in ((4, 3), (5, 1), (3, 130)):
        counts = [1 + (b * 7) % K for b in range(B)]
        chunks = {0} if entries == 0 else {1, 2, K}
        for chunk in sorted(chunks | {ops.ad_chunk(entries, K, B)}):
            tangent, primal = _ad_threads(K, B, nc, chunk, counts)
            assert sorted(tangent) == [(s, c, b) for s in range(K)
                                       for c in range(nc) for b in range(B)]
            assert all(len(v) == 1 for v in tangent.values())
            assert sorted(primal) == ([] if chunk == 0 else [
                (s, b) for s in range(K) for b in range(B)
                if s < counts[b]])
            assert all(len(v) == 1 and v[0] <= s < v[0] + chunk
                       for (s, _), v in primal.items())
    # two passes wherever a (slot, lane) has primal entries, the walker's
    # B=1 replan (40 slots) too; push_lcl's 1000 SI_1 slots of 128 scenes
    # one chunk of 527 doubles each (540 MB), under the cap
    for K, B in ((40, 1), (1000, 128), (1500, 128), (20000, 512)):
        chunk = ops.ad_chunk(entries, K, B)
        if entries == 0:
            assert chunk == 0
            continue
        assert 1 <= chunk <= K
        assert 8 * entries * B * chunk <= max(ops.AD_PRIMAL_CAP_BYTES,
                                              8 * entries * B)
        if chunk < K:
            assert 8 * entries * B * (chunk + 1) > ops.AD_PRIMAL_CAP_BYTES


# ---------------------------------------------------------------------------
# host builds of the kernels (g++, a stub CUDA runtime)
# ---------------------------------------------------------------------------

STUB = r"""
#pragma once
#include <math.h>
#include <cmath>
#include <algorithm>
#include <barrier>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __constant__
#define __shared__
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
struct HostWarp {
  std::barrier<> bar;
  double slot[32];
  explicit HostWarp(int n) : bar(n) {}
};
inline thread_local HostWarp* host_warp = nullptr;
inline thread_local std::barrier<>* host_block = nullptr;
inline void __syncwarp(unsigned = 0xffffffffu) { host_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { host_block->arrive_and_wait(); }
inline double __shfl_sync(unsigned, double v, int src) {
  host_warp->slot[threadIdx.x % 32] = v;
  host_warp->bar.arrive_and_wait();
  const double r = host_warp->slot[src];
  host_warp->bar.arrive_and_wait();
  return r;
}
// one block at a time, a std::thread per CUDA thread, a barrier per warp
inline void host_launch(dim3 g, dim3 b, std::function<void()> fn) {
  for (unsigned bx = 0; bx < g.x; ++bx) {
    std::vector<std::unique_ptr<HostWarp>> warps;
    for (unsigned w = 0; w < (b.x + 31) / 32; ++w)
      warps.emplace_back(new HostWarp(std::min(32u, b.x - 32 * w)));
    std::barrier<> block(b.x);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < b.x; ++t)
      threads.emplace_back([&, t] {
        threadIdx = dim3(t); blockIdx = dim3(bx); blockDim = b; gridDim = g;
        host_warp = warps[t / 32].get();
        host_block = &block;
        fn();
      });
    for (auto& th : threads) th.join();
  }
}
"""

HOST_ENTRIES = r"""
namespace trajopt { double smem[1 << 16]; }
extern "C" int host_thread_linesearch(
    const double* P, const double* W, const double* qnom, const double* vnom,
    const double* U, const double* kff, const double* Kfb,
    const double* alphas, const double* tgt, double* qpos, double* qvel,
    double* ctrl, double* costs, int H, int A, int B) {
  using T = trajopt::Topo<HOST_TOPO>;
  const int n = A * B;
  host_launch(dim3((n + 63) / 64), dim3(64), [&] {
    trajopt::linesearch_kernel<T>(P, W, qnom, vnom, U, kff, Kfb, alphas, tgt,
                                  qpos, qvel, ctrl, costs, H, A, B);
  });
  return 0;
}
"""
# each instance's layout sizes, as the C++ structs count them
HOST_SIZES = """
extern "C" int host_lane_doubles_{tag}() {{
  return trajopt::WarpLayout<trajopt::Topo<Topo_{tag}>>::DOUBLES;
}}
extern "C" int host_ad_entries_{tag}() {{
  return trajopt::AdLayout<trajopt::Topo<Topo_{tag}>>::ENTRIES;
}}
extern "C" int host_tables_bytes_{tag}() {{
  return sizeof(trajopt::WarpTables<trajopt::Topo<Topo_{tag}>>);
}}
"""


def _host_launches(src: str) -> str:
    """Every `kernel<<<grid, block, ...>>>(args)` of preprocessed source
    as host_launch(grid, block, [&]{ kernel(args); })."""
    out, i = [], 0
    pat = re.compile(r"([\w:]+(?:\s*<[^<>;]*>)?)\s*<<<")
    while (m := pat.search(src, i)) is not None:
        out.append(src[i:m.start()])
        j = src.index(">>>", m.end())
        grid, block = (x.strip() for x in src[m.end():j].split(",")[:2])
        k = src.index("(", j)
        depth, e = 0, k
        while True:
            depth += {"(": 1, ")": -1}.get(src[e], 0)
            if depth == 0:
                break
            e += 1
        out.append(f"host_launch(dim3({grid}), dim3({block}), [&]{{ "
                   f"{m.group(1)}({src[k + 1:e]}); }})")
        i = e + 1
    return "".join(out) + src[i:]


def _host_library(tmp_path, tag):
    """linesearch.cu of one instance, built for the host with the entries
    above -> ctypes library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    (tmp_path / "stub").mkdir(exist_ok=True)
    (tmp_path / "stub" / "cuda_runtime.h").write_text(STUB)
    pre = subprocess.run(
        [gxx, "-x", "c++", "-std=c++20", "-E", "-P",
         f"-I{tmp_path / 'stub'}", f"-I{build.CSRC}",
         f"-DTRAJOPT_ONLY=TRAJOPT_MODEL_{tag}",
         str(build.CSRC / "linesearch.cu")],
        capture_output=True, text=True, check=True).stdout
    src = (_host_launches(pre) + HOST_ENTRIES.replace("HOST_TOPO",
                                                      f"Topo_{tag}")
           + "".join(HOST_SIZES.format(tag=t) for t in TABLES))
    cpp = tmp_path / f"linesearch_{tag}.cpp"
    cpp.write_text(src)
    lib = tmp_path / f"linesearch_{tag}.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                        "-fPIC", "-shared", "-pthread", "-w", "-o", str(lib),
                        str(cpp)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("host_kernels")


def test_layouts_mirror_the_kernels(host_dir):
    """linesearch_lane_doubles, warp_tables_bytes and ad_primal_entries
    count what the C++ structs lay out at every instance (the C entries
    refuse any other geometry or buffer on the card)."""
    lib = _host_library(host_dir, "push_ncl")
    for tag, t in TABLES.items():
        assert getattr(lib, f"host_lane_doubles_{tag}")() == \
            ops.linesearch_lane_doubles(t), tag
        assert getattr(lib, f"host_ad_entries_{tag}")() == \
            ops.ad_primal_entries(t), tag
        assert getattr(lib, f"host_tables_bytes_{tag}")() == \
            ops.warp_tables_bytes(t), tag


def _line_search_inputs(task, H, B, seed):
    """Scenes with every limited joint at a limit in half the lanes, random
    velocities, controls and gains, and the twin's nominal rollout."""
    m = task.model
    rng = np.random.default_rng(seed)
    qp, _, tg = lanes.scenes(task, B, seed=seed)
    half = max(1, B // 2)
    rngl = m.jnt_range.cpu().numpy()
    for j in (j for j, lim in enumerate(m.jnt_limited) if lim):
        side = rng.integers(0, 2, half)
        qp[:half, m.jnt_qposadr[j]] = torch.as_tensor(
            np.where(side == 0, rngl[j, 0], rngl[j, 1])
            + 0.01 * rng.standard_normal(half))
    f64 = dict(dtype=torch.float64)
    qv = torch.as_tensor(0.5 * rng.standard_normal((B, m.nv)), **f64)
    U = torch.as_tensor(rng.standard_normal((H, m.nu, B)), **f64)
    k = torch.as_tensor(0.1 * rng.standard_normal((H, m.nu, B)), **f64)
    K = torch.as_tensor(0.05 * rng.standard_normal(
        (H, m.nu, task.sv.nx, B)), **f64)
    tg = tg.T.contiguous()
    qpos, qvel, _ = ilqr.rollout(task, qp.T.contiguous(), qv.T.contiguous(),
                                 U, tg)
    return qpos.contiguous(), qvel.contiguous(), U, k, K, tg


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("tag", ["pentabot", "reaching", "push_ncl",
                                 "walker", "box_sweep"])
def test_warp_line_search_equals_thread_line_search(host_dir, tag):
    """The warp-per-lane K4 (csrc/warp_step.cuh) equals the one-thread K4
    bit for bit on the host, at one scene of six alphas over two steps in
    blocks of four lanes (the last block half full), with joint limits at
    their bounds and contacts: every sum runs in the one-thread step's
    order."""
    task = make_task(TASKS[tag], device="cpu")
    ka = ops.kernel_args(task, torch.device("cpu"))
    H, B = 2, 1
    qpos, qvel, U, k, K, tg = _line_search_inputs(task, H, B, seed=3)
    alphas = ilqr.default_alphas(ALPHAS, device="cpu")
    lib = _host_library(host_dir, tag)
    m = task.model
    f64 = dict(dtype=torch.float64)

    def outputs():
        return [torch.full(s, float("nan"), **f64) for s in (
            (H + 1, m.nq, ALPHAS, B), (H + 1, m.nv, ALPHAS, B),
            (H, m.nu, ALPHAS, B), (H, ALPHAS, B))]

    args = [_p(x) for x in (ka.model_buf, ka.task_buf, qpos, qvel, U, k, K,
                            alphas, tg)]
    warp, thread = outputs(), outputs()
    g = ops.linesearch_geometry(TABLES[tag], ALPHAS, B)
    assert g.warp
    lanes4 = 4
    per_lane = g.smem_bytes // g.lanes
    err = getattr(lib, f"trajopt_linesearch_{tag}")(
        *args, *[_p(x) for x in warp], ctypes.c_int(H), ctypes.c_int(ALPHAS),
        ctypes.c_int(B), ctypes.c_int(32 * lanes4), ctypes.c_int(lanes4),
        ctypes.c_int(per_lane * lanes4), ctypes.c_void_p(None))
    assert err == 0
    # a geometry the kernel does not run is refused
    assert getattr(lib, f"trajopt_linesearch_{tag}")(
        *args, *[_p(x) for x in outputs()], ctypes.c_int(H),
        ctypes.c_int(ALPHAS), ctypes.c_int(B), ctypes.c_int(64),
        ctypes.c_int(64), ctypes.c_int(0), ctypes.c_void_p(None)) != 0
    lib.host_thread_linesearch(*args, *[_p(x) for x in thread],
                               ctypes.c_int(H), ctypes.c_int(ALPHAS),
                               ctypes.c_int(B))
    for a, b in zip(warp, thread):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(name, H, B, seed):
    task = make_task(name, device="cuda")
    qpos, qvel, U, k, K, tg = (x.cuda() for x in _line_search_inputs(
        make_task(name, device="cpu"), H, B, seed))
    return task, qpos, qvel, U, k, K, tg


def _same(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(set(TASKS.values())))
@pytest.mark.parametrize("B", [1, 3, 130])
def test_card_linesearch_equals_twin(cuda, name, B):
    """K4 on the card equals its twin bit for bit (lanes ordered by scene,
    the last block partly empty at B = 3 in blocks of four lanes)."""
    task, qpos, qvel, U, k, K, tg = _card_inputs(name, 4, B, seed=B)
    alphas = ilqr.default_alphas(ALPHAS, device="cuda")
    plain = ops.linesearch(task, qpos, qvel, U, k, K, alphas, tg, plain=True)
    g = ops.linesearch_geometry(build.instance_tables()[
        ops.kernel_args(task, U.device).tag], ALPHAS, B)
    plans = [g]
    if g.warp:
        plans.append(g._replace(lanes=4, threads=128,
                                smem_bytes=g.smem_bytes // g.lanes * 4))
    for geo in plans:
        out = ops.linesearch(task, qpos, qvel, U, k, K, alphas, tg,
                             geometry=geo)
        assert all(_same(a, b) for a, b in zip(out, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(set(TASKS.values())))
@pytest.mark.parametrize("B", [1, 3, 130])
def test_card_ad_jacobian_equals_twin(cuda, name, B):
    """K5ad on the card equals its twin bit for bit at shared slot times,
    per-lane times with live counts (dead slots zero) and scattered into
    the iterative_error cache, with one slot a chunk and all at once (one
    pass where the model has no primal entries)."""
    H = 5
    task, qpos, qvel, U, _, _, _ = _card_inputs(name, H, B, seed=B + 1)
    g = torch.Generator().manual_seed(B)
    times = torch.arange(H, device="cuda")
    slot_t = torch.sort(torch.randint(0, H, (4, B), generator=g),
                        dim=0).values.cuda().contiguous()
    counts = torch.randint(1, 5, (B,), generator=g,
                           dtype=torch.int32).cuda()
    nx, nc = task.sv.nx, task.sv.nx + task.model.nu
    cap = ops.AD_PRIMAL_CAP_BYTES
    try:
        for c in (cap, 1):
            ops.AD_PRIMAL_CAP_BYTES = c
            assert _same(ops.ad_jacobian(task, qpos, qvel, U, times),
                         ops.ad_jacobian(task, qpos, qvel, U, times,
                                         plain=True))
            assert _same(ops.ad_jacobian(task, qpos, qvel, U, slot_t,
                                         counts=counts),
                         ops.ad_jacobian(task, qpos, qvel, U, slot_t,
                                         counts=counts, plain=True))
            caches = []
            for plain in (False, True):
                cache = torch.zeros((H, nx, nc, B), dtype=torch.float64,
                                    device="cuda")
                ops.ad_jacobian(task, qpos, qvel, U, slot_t, counts=counts,
                                cache=cache, plain=plain)
                caches.append(cache)
            assert _same(*caches)
    finally:
        ops.AD_PRIMAL_CAP_BYTES = cap
