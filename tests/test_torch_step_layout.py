"""K3's, K4's, K5's and K5ad's launch plans (kernels/ops.py:
linesearch_geometry, at A = 1 for K3, fd_geometry, ad_primal_entries,
ad_chunk) in pure Python, at every model instance of
kernels/csrc/instances.cuh and at the sizes of the moderate-clutter pushing
task (nv 55, 45 contact pairs, nx 62); the plans' byte counts against the
C++ structs they mirror (csrc/warp_step.cuh:WarpLayout,
csrc/constraint.cuh:AdLayout); compiled by the host's g++ with a stub CUDA
runtime (one std::thread per CUDA thread, a std::barrier per warp for
__syncwarp and __shfl_sync, one per block for __syncthreads, four blocks
at a time), the warp-per-lane line search against the one-thread line
search, the warp-per-scene rollout (K4's kernel in its open loop) against
the one-thread rollout and the warp-per-item central FD against its
one-thread build, bit for bit, and the FD against its twin (with libm's
sin, cos, atan2 and sqrt) within the FD bar; and on the card the four
kernels against their plain twins.  The card's tests skip elsewhere; run
them there with
python -m pytest tests/test_torch_step_layout.py -m cuda --noconftest
"""

import contextlib
import ctypes
import math
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


@pytest.mark.parametrize("tag", sorted(TABLES))
def test_rollout_plan_covers_every_scene_once(tag):
    """K3's plan is K4's at A = 1: a warp per scene with constraint rows
    (one scene a block up to 132 scenes, so the main paths' 128 take one
    SM each), a thread per scene without; every scene one warp or thread
    in one block."""
    t = TOPOS[tag]
    for B in SCENES:
        g = ops.linesearch_geometry(t, 1, B)
        assert g.warp == (ops.step_sizes(t).rows > 0)
        if g.warp:
            assert g.lanes == -(-B // ops.NUM_SMS)
            assert g.smem_bytes + ops.warp_tables_bytes(t) <= ops.SMEM_LIMIT
        per = 32 if g.warp else 1
        owners = {}
        for block in range(g.blocks(1, B)):
            for thread in range(g.threads):
                a, b = g.lane(block, thread, 1)
                if b < B:
                    assert a == 0
                    owners.setdefault(b, set()).add((block, thread))
        assert sorted(owners) == list(range(B))
        assert all(len(v) == per and len({k for k, _ in v}) == 1
                   for v in owners.values())


FD_SHAPES = ((1, 1), (50, 1), (3, 5), (2, 130), (100, 64))


@pytest.mark.parametrize("tag", sorted(TABLES))
def test_fd_geometry_fits_a_block(tag):
    """K5: a warp per (slot, column, scene) item with constraint rows, at
    most LS_MAX_LANES items and 227 KB a block with the tables, as many
    items a block as fill the SMs; a thread per item in blocks of 64
    without rows.  The async push_ncl planner's 50 slots of one scene
    (1350 items) take eight items a block."""
    t = TOPOS[tag]
    nc = 2 * t.NDOF + t.NU
    for K, B in FD_SHAPES:
        g = ops.fd_geometry(t, K, B)
        if ops.step_sizes(t).rows == 0:
            assert (g.threads, g.lanes, g.smem_bytes, g.warp) == (
                64, 64, 0, False)
            continue
        assert g.warp and g.threads == 32 * g.lanes
        assert g.smem_bytes == 8 * ops.fd_lane_doubles(t) * g.lanes
        assert g.smem_bytes + ops.warp_tables_bytes(t) <= ops.SMEM_LIMIT
        assert g.lanes == min(ops.LS_MAX_LANES, -(-K * nc * B // ops.NUM_SMS),
                              (ops.SMEM_LIMIT - ops.warp_tables_bytes(t))
                              // (8 * ops.fd_lane_doubles(t)))
        assert g.blocks_per_sm >= 1
    if tag == "push_ncl":
        assert ops.fd_geometry(t, 50, 1).lanes == 8


@pytest.mark.parametrize("tag", sorted(TABLES))
def test_fd_plan_covers_every_item_once(tag):
    """Every (slot, column, scene) item has one warp (or one thread) in
    one block, the scenes of a (slot, column) side by side, and the last
    block holds an item; also in blocks of three items."""
    t = TOPOS[tag]
    nc = 2 * t.NDOF + t.NU
    for K, B in ((1, 1), (2, 3), (3, 5)):
        g0 = ops.fd_geometry(t, K, B)
        plans = [g0] + ([g0._replace(lanes=3, threads=96,
                                     smem_bytes=g0.smem_bytes // g0.lanes
                                     * 3)] if g0.warp else [])
        n = K * nc * B
        for g in plans:
            per = 32 if g.warp else 1
            owners = {}
            for block in range(g.blocks(n)):
                for thread in range(g.threads):
                    s_, c, b = g.item(block, thread, nc, B)
                    if s_ < K:
                        owners.setdefault((s_, c, b), set()).add(
                            (block, thread))
            assert sorted(owners) == [(s_, c, b) for s_ in range(K)
                                      for c in range(nc) for b in range(B)]
            assert all(len(v) == per and len({k for k, _ in v}) == 1
                       for v in owners.values())
            assert (g.blocks(n) - 1) * g.lanes < n <= g.blocks(n) * g.lanes
            first = g.item(0, per, nc, B) if g.lanes > 1 else None
            if first is not None and B > 1:
                assert first == (0, 0, 1)    # the scene fastest


def test_linesearch_refuses_a_lane_past_a_block():
    """A lane whose arrays pass the 227 KB a block may take is refused,
    naming its bytes: K4's and K3's lane, and K5's item; past 32 dofs K5
    is refused as K4 is."""
    t = TABLES["push_lcl"]
    big = t._replace(PAIRS=t.PAIRS * 30)
    need = 8 * ops.linesearch_lane_doubles(big)
    assert need + ops.warp_tables_bytes(big) > ops.SMEM_LIMIT
    with pytest.raises(NotImplementedError, match=f"needs {need} bytes"):
        ops.linesearch_geometry(big, ALPHAS, 128)
    with pytest.raises(NotImplementedError, match=f"needs {need} bytes"):
        ops.linesearch_geometry(big, 1, 128)
    need = 8 * ops.fd_lane_doubles(big)
    with pytest.raises(NotImplementedError, match=f"K5's lane needs {need}"):
        ops.fd_geometry(big, 1, 1)
    with pytest.raises(NotImplementedError, match="up to 32 dofs, not 55"):
        ops.fd_geometry(TOPOS["push_mcl"], 1, 1)


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
// the block's dynamic shared memory (the kernels' `extern __shared__
// double smem[]` is rewritten to read it)
inline thread_local double* host_smem = nullptr;
inline void __syncwarp(unsigned = 0xffffffffu) { host_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { host_block->arrive_and_wait(); }
inline double __shfl_sync(unsigned, double v, int src) {
  host_warp->slot[threadIdx.x % 32] = v;
  host_warp->bar.arrive_and_wait();
  const double r = host_warp->slot[src];
  host_warp->bar.arrive_and_wait();
  return r;
}
// HOST_BLOCKS blocks at a time, each with its own shared memory, a
// std::thread per CUDA thread, a barrier per warp and one per block
constexpr unsigned HOST_BLOCKS = 4;
inline void host_launch(dim3 g, dim3 b, std::function<void()> fn) {
  const unsigned nw = (b.x + 31) / 32;
  for (unsigned b0 = 0; b0 < g.x; b0 += HOST_BLOCKS) {
    const unsigned nb = std::min(HOST_BLOCKS, g.x - b0);
    std::vector<std::unique_ptr<HostWarp>> warps;
    std::vector<std::unique_ptr<std::barrier<>>> blocks;
    std::vector<std::vector<double>> mem(nb, std::vector<double>(1 << 15));
    for (unsigned k = 0; k < nb; ++k) {
      blocks.emplace_back(new std::barrier<>(b.x));
      for (unsigned w = 0; w < nw; ++w)
        warps.emplace_back(new HostWarp(std::min(32u, b.x - 32 * w)));
    }
    std::vector<std::thread> threads;
    for (unsigned k = 0; k < nb; ++k)
      for (unsigned t = 0; t < b.x; ++t)
        threads.emplace_back([&, k, t] {
          threadIdx = dim3(t); blockIdx = dim3(b0 + k); blockDim = b;
          gridDim = g;
          host_warp = warps[k * nw + t / 32].get();
          host_block = blocks[k].get();
          host_smem = mem[k].data();
          fn();
        });
    for (auto& th : threads) th.join();
  }
}
"""

HOST_ENTRIES = r"""
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
// K3's one-thread rollout, which the card builds only without rows
extern "C" int host_thread_rollout(
    const double* P, const double* W, const double* qp0, const double* qv0,
    const double* U, const double* tgt, double* qpos, double* qvel,
    double* costs, int H, int B) {
  using T = trajopt::Topo<HOST_TOPO>;
  host_launch(dim3((B + 63) / 64), dim3(64), [&] {
    trajopt::rollout_kernel<T>(P, W, qp0, qv0, U, tgt, qpos, qvel, costs, H,
                               B);
  });
  return 0;
}
// K5 a thread per (slot, column, scene) item at any instance: the
// reference of the warp kernel
extern "C" int host_thread_fd(
    const double* P, const double* qpos, const double* qvel, const double* U,
    const long long* times, long long ts_s, long long ts_b, const int* counts,
    int scatter, double eps, double* J, int K, int B) {
  using T = trajopt::Topo<HOST_TOPO>;
  const long long n = (long long)K * (T::NX + T::NU) * B;
  host_launch(dim3((n + 63) / 64), dim3(64), [&] {
    trajopt::fd_thread_kernel<T>(P, qpos, qvel, U, times, ts_s, ts_b, counts,
                                 scatter, eps, J, K, B);
  });
  return 0;
}
"""
# each instance's layout sizes, as the C++ structs count them
HOST_SIZES = """
extern "C" int host_lane_doubles_{tag}() {{
  return trajopt::WarpLayout<trajopt::Topo<Topo_{tag}>>::DOUBLES;
}}
extern "C" int host_fd_doubles_{tag}() {{
  return trajopt::WarpLayout<trajopt::Topo<Topo_{tag}>>::FD_DOUBLES;
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


# linesearch.cu (K4, and K3's open loop), fd_jacobian.cu (K5) and
# rollout.cu (K3's one-thread kernel) in one translation unit, the error
# string named once
HOST_UNIT = r"""
#include "instances.cuh"
#undef TRAJOPT_DEFINE_ERROR_STRING
#define TRAJOPT_DEFINE_ERROR_STRING
#include "linesearch.cu"
#include "fd_jacobian.cu"
#include "rollout.cu"
extern "C" const char* trajopt_error_string(int) { return "host"; }
"""


_HOST_LIBS: dict = {}


def _host_library(tmp_path, tag):
    """linesearch.cu, fd_jacobian.cu and rollout.cu of one instance, built
    for the host with the entries above (once per directory) -> ctypes
    library."""
    key = (str(tmp_path), tag)
    if key not in _HOST_LIBS:
        _HOST_LIBS[key] = _build_host_library(tmp_path, tag)
    return _HOST_LIBS[key]


def _build_host_library(tmp_path, tag):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    (tmp_path / "stub").mkdir(exist_ok=True)
    (tmp_path / "stub" / "cuda_runtime.h").write_text(STUB)
    (tmp_path / "unit.cu").write_text(HOST_UNIT)
    pre = subprocess.run(
        [gxx, "-x", "c++", "-std=c++20", "-E", "-P",
         f"-I{tmp_path / 'stub'}", f"-I{build.CSRC}",
         f"-DTRAJOPT_ONLY=TRAJOPT_MODEL_{tag}",
         str(tmp_path / "unit.cu")],
        capture_output=True, text=True, check=True).stdout
    pre = re.sub(r"extern\s+double\s+smem\[\];", "double* smem = host_smem;",
                 pre)
    src = (_host_launches(pre) + HOST_ENTRIES.replace("HOST_TOPO",
                                                      f"Topo_{tag}")
           + "".join(HOST_SIZES.format(tag=t) for t in TABLES))
    cpp = tmp_path / f"steps_{tag}.cpp"
    cpp.write_text(src)
    lib = tmp_path / f"steps_{tag}.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                        "-fPIC", "-shared", "-pthread", "-w", "-o", str(lib),
                        str(cpp)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("host_kernels")


def test_layouts_mirror_the_kernels(host_dir):
    """linesearch_lane_doubles, fd_lane_doubles, warp_tables_bytes and
    ad_primal_entries count what the C++ structs lay out at every instance
    (the C entries refuse any other geometry or buffer on the card)."""
    lib = _host_library(host_dir, "push_ncl")
    for tag, t in TABLES.items():
        assert getattr(lib, f"host_lane_doubles_{tag}")() == \
            ops.linesearch_lane_doubles(t), tag
        assert getattr(lib, f"host_fd_doubles_{tag}")() == \
            ops.fd_lane_doubles(t), tag
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


HOST_STEPS = ["pentabot", "reaching", "push_ncl", "walker", "box_sweep"]
# the FD bar of tests/test_torch_kernels.py: rounding divided by 2 eps
FD_BAR = 1e-6
NULL = ctypes.c_void_p(None)


@contextlib.contextmanager
def _libm_twin():
    """torch's CPU sin, cos, atan2 and sqrt replaced by libm's (`math`),
    which the host build of the kernels calls: torch's vectorised CPU
    versions round some doubles an ulp away, and at the walker's and the
    box's contacts that flipped a gate, whose jump FD divides by 2 eps."""
    def elementwise(fn):
        def f(*xs):
            xs = torch.broadcast_tensors(*xs)
            vals = zip(*(x.reshape(-1).tolist() for x in xs))
            return torch.tensor([fn(*v) for v in vals],
                                dtype=xs[0].dtype).reshape(xs[0].shape)
        return f

    saved = torch.sin, torch.cos, torch.sqrt, torch.atan2
    torch.sin, torch.cos = elementwise(math.sin), elementwise(math.cos)
    torch.sqrt = elementwise(lambda v: math.sqrt(v) if v >= 0 else math.nan)
    torch.atan2 = elementwise(math.atan2)
    try:
        yield
    finally:
        torch.sin, torch.cos, torch.sqrt, torch.atan2 = saved


def _fd_twin(task, qpos, qvel, U, times, **kw):
    with _libm_twin():
        return ops.fd_jacobian(task, qpos, qvel, U, times, 1e-6, **kw)


def _rollout_outputs(m, H, B):
    f64 = dict(dtype=torch.float64)
    return [torch.full(s, float("nan"), **f64)
            for s in ((H + 1, m.nq, B), (H + 1, m.nv, B), (H, B))]


@pytest.mark.parametrize("tag", HOST_STEPS)
def test_warp_rollout_equals_thread_rollout(host_dir, tag):
    """K3 with constraint rows, the warp kernel of K4 in its open loop
    (null gains, A = 1), equals the one-thread rollout bit for bit on the
    host at one scene and three over two steps (three also in blocks of
    two lanes, the last half full) and 130 over one step, in its plan's
    geometry, with joint limits at their bounds and contacts; the open
    loop at A = 2 and the one-thread C entry at an instance with rows are
    refused."""
    task = make_task(TASKS[tag], device="cpu")
    ka = ops.kernel_args(task, torch.device("cpu"))
    lib = _host_library(host_dir, tag)
    entry = getattr(lib, f"trajopt_linesearch_{tag}")
    for B, H in ((1, 2), (3, 2), (130, 1)):
        qpos, qvel, U, _, _, tg = _line_search_inputs(task, H, B, seed=B)
        qp0, qv0 = qpos[0].contiguous(), qvel[0].contiguous()
        ins = [_p(x) for x in (ka.model_buf, ka.task_buf, qp0, qv0, U)]
        g = ops.linesearch_geometry(TABLES[tag], 1, B)
        assert g.warp
        plans = [g] + ([g._replace(lanes=2, threads=64,
                                   smem_bytes=g.smem_bytes // g.lanes * 2)]
                       if B == 3 else [])
        thread = _rollout_outputs(task.model, H, B)
        lib.host_thread_rollout(*ins, _p(tg), *[_p(x) for x in thread],
                                ctypes.c_int(H), ctypes.c_int(B))
        for geo in plans:
            warp = _rollout_outputs(task.model, H, B)
            q, v, c = (_p(x) for x in warp)
            assert entry(*ins, NULL, NULL, NULL, _p(tg), q, v, NULL, c,
                         ctypes.c_int(H), ctypes.c_int(1), ctypes.c_int(B),
                         ctypes.c_int(geo.threads), ctypes.c_int(geo.lanes),
                         ctypes.c_int(geo.smem_bytes), NULL) == 0
            for a, b in zip(warp, thread):
                assert bool(torch.isfinite(a).all())
                assert torch.equal(a, b)
    out = [_p(x) for x in _rollout_outputs(task.model, 1, 2)]
    assert entry(*ins, NULL, NULL, NULL, _p(tg), out[0], out[1], NULL,
                 out[2], ctypes.c_int(1), ctypes.c_int(2), ctypes.c_int(1),
                 ctypes.c_int(g.threads), ctypes.c_int(g.lanes),
                 ctypes.c_int(g.smem_bytes), NULL) != 0
    assert getattr(lib, f"trajopt_rollout_{tag}")(
        *ins, _p(tg), *out, ctypes.c_int(1), ctypes.c_int(1), NULL) != 0


def _fd_launch(lib, tag, ka, qpos, qvel, U, times, counts, J, geo=None,
               scatter=False):
    """K5's C entry at eps 1e-6 (geo: its plan, or None for the one-thread
    reference at any instance)."""
    B = U.shape[-1]
    stride = (B, 1) if times.dim() == 2 else (1, 0)
    args = [_p(ka.model_buf), _p(qpos), _p(qvel), _p(U), _p(times),
            ctypes.c_longlong(stride[0]), ctypes.c_longlong(stride[1]),
            NULL if counts is None else _p(counts), ctypes.c_int(scatter),
            ctypes.c_double(1e-6), _p(J), ctypes.c_int(times.shape[0]),
            ctypes.c_int(B)]
    if geo is None:
        return lib.host_thread_fd(*args)
    return getattr(lib, f"trajopt_fd_jacobian_{tag}")(
        *args, ctypes.c_int(geo.threads), ctypes.c_int(geo.lanes),
        ctypes.c_int(geo.smem_bytes), NULL)


@pytest.mark.parametrize("tag", HOST_STEPS)
def test_warp_fd_equals_thread_fd(host_dir, tag):
    """K5 with constraint rows, a warp per (slot, column, scene) item over
    the cooperative step, equals the one-thread build of the same columns
    bit for bit on the host, at one slot of one scene with its limits at
    their bounds or contacts, and its twin (derivs/fd.py) within the FD
    bar; a plan the kernel does not run is refused."""
    task = make_task(TASKS[tag], device="cpu")
    ka = ops.kernel_args(task, torch.device("cpu"))
    lib = _host_library(host_dir, tag)
    qpos, qvel, U, _, _, _ = _line_search_inputs(task, 2, 1, seed=7)
    times = torch.tensor([1])
    nx, nc = task.sv.nx, task.sv.nx + task.model.nu
    f64 = dict(dtype=torch.float64)
    g = ops.fd_geometry(TABLES[tag], 1, 1)
    assert g.warp and g.lanes == 1
    warp, thread = (torch.full((1, nx, nc, 1), float("nan"), **f64)
                    for _ in range(2))
    assert _fd_launch(lib, tag, ka, qpos, qvel, U, times, None, warp, g) == 0
    _fd_launch(lib, tag, ka, qpos, qvel, U, times, None, thread)
    assert bool(torch.isfinite(warp).all())
    assert torch.equal(warp, thread)
    twin = _fd_twin(task, qpos, qvel, U, times)
    assert float((warp - twin).abs().max()) < FD_BAR
    assert _fd_launch(lib, tag, ka, qpos, qvel, U, times, None, warp,
                      g._replace(smem_bytes=g.smem_bytes + 8)) != 0


def test_warp_fd_slot_modes(host_dir):
    """K5's warp kernel in its three slot modes at pentabot (capsule pairs
    touching), two slots of two scenes: shared times, per-lane times with
    a dead slot (zeros in its columns) and scattered into the
    iterative_error cache (a dead slot writes nothing), in blocks of three
    items (the last block part full): bit for bit with the one-thread
    build and within the FD bar of the twin."""
    tag = "pentabot"
    task = make_task(TASKS[tag], device="cpu")
    ka = ops.kernel_args(task, torch.device("cpu"))
    lib = _host_library(host_dir, tag)
    H, B = 3, 2
    qpos, qvel, U, _, _, _ = _line_search_inputs(task, H, B, seed=9)
    nx, nc = task.sv.nx, task.sv.nx + task.model.nu
    f64 = dict(dtype=torch.float64)
    shared = torch.tensor([0, 2])
    slot_t = torch.tensor([[0, 1], [2, 0]])          # (K, B)
    counts = torch.tensor([2, 1], dtype=torch.int32)
    g = ops.fd_geometry(TABLES[tag], 2, B)
    g3 = g._replace(lanes=3, threads=96, smem_bytes=g.smem_bytes // g.lanes
                    * 3)
    assert 2 * nc * B % 3
    for times, cnt, cache in ((shared, None, False), (slot_t, counts, False),
                              (slot_t, counts, True)):
        shape = (H if cache else 2, nx, nc, B)
        outs = [torch.full(shape, -7.0 if cache else float("nan"), **f64)
                for _ in range(3)]
        for out, geo in zip(outs, (g, g3, None)):
            assert _fd_launch(lib, tag, ka, qpos, qvel, U, times, cnt, out,
                              geo, scatter=cache) == 0
        assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1],
                                                             outs[2])
        twin = _fd_twin(task, qpos, qvel, U, times, counts=cnt,
                        cache=torch.full(shape, -7.0, **f64) if cache
                        else None)
        assert float((outs[0] - twin).abs().max()) < FD_BAR
        if cnt is not None and not cache:
            assert bool((outs[0][1, ..., 1] == 0).all())
        if cache:
            # scene 1's dead slot (time 0) and the time no slot takes
            for t, b in ((0, 1), (2, 1), (1, 0)):
                assert bool((outs[0][t, ..., b] == -7.0).all())


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
def test_card_rollout_equals_twin(cuda, name, B):
    """K3 on the card equals its twin bit for bit: a warp per scene with
    constraint rows (also in blocks of two scenes), a thread per scene
    without; counted as one rollout launch."""
    task, qpos, qvel, U, _, _, tg = _card_inputs(name, 4, B, seed=B + 2)
    qp0, qv0 = qpos[0].contiguous(), qvel[0].contiguous()
    plain = ops.rollout(task, qp0, qv0, U, tg, plain=True)
    g = ops.linesearch_geometry(build.instance_tables()[
        ops.kernel_args(task, U.device).tag], 1, B)
    plans = [g] + ([g._replace(lanes=2, threads=64,
                               smem_bytes=g.smem_bytes // g.lanes * 2)]
                   if g.warp else [])
    for geo in plans:
        n = ops.LAUNCHES["rollout"]
        out = ops.rollout(task, qp0, qv0, U, tg, geometry=geo)
        assert ops.LAUNCHES["rollout"] == n + 1
        assert all(_same(a, b) for a, b in zip(out, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(set(TASKS.values())))
@pytest.mark.parametrize("B", [1, 3, 130])
def test_card_fd_jacobian_equals_twin(cuda, name, B):
    """K5 on the card equals its twin bit for bit at shared slot times,
    per-lane times with live counts (dead slots zero) and scattered into
    the iterative_error cache, in its plan and (a warp per item) in blocks
    of three items."""
    H = 4
    task, qpos, qvel, U, _, _, _ = _card_inputs(name, H, B, seed=B + 3)
    gen = torch.Generator().manual_seed(B + 3)
    times = torch.arange(H, device="cuda")
    slot_t = torch.sort(torch.randint(0, H, (3, B), generator=gen),
                        dim=0).values.cuda().contiguous()
    counts = torch.randint(1, 4, (B,), generator=gen,
                           dtype=torch.int32).cuda()
    nx, nc = task.sv.nx, task.sv.nx + task.model.nu
    tag = build.step_shared()[ops.kernel_args(task, U.device).tag]
    for K, t_, c_ in ((H, times, None), (3, slot_t, counts)):
        g = ops.fd_geometry(build.instance_tables()[tag], K, B)
        plans = [g] + ([g._replace(lanes=3, threads=96,
                                   smem_bytes=g.smem_bytes // g.lanes * 3)]
                       if g.warp else [])
        want = ops.fd_jacobian(task, qpos, qvel, U, t_, 1e-6, counts=c_,
                               plain=True)
        for geo in plans:
            assert _same(ops.fd_jacobian(task, qpos, qvel, U, t_, 1e-6,
                                         counts=c_, geometry=geo), want)
    caches = []
    for plain in (False, True):
        cache = torch.zeros((H, nx, nc, B), dtype=torch.float64,
                            device="cuda")
        ops.fd_jacobian(task, qpos, qvel, U, slot_t, 1e-6, counts=counts,
                        cache=cache, plain=plain)
        caches.append(cache)
    assert _same(*caches)


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
