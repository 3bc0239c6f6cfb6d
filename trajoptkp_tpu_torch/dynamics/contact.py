"""Soft-constraint rows and their solver (counterpart of
`trajoptkp_tpu/dynamics/contact.py`): joint-limit rows and the cold-start
projected-Newton solve.  Contact rows are ROADMAP Queue 1 item 7b.

MuJoCo's constraint model, as in the JAX package: impedance d(pos) from
solimp, stiffness and damping from solref,

    b = 2 / (dmax tc),  k = d / (dmax^2 tc^2 dr^2),
    aref = -b (J qvel) - k (dist - margin),  R = (1 - d)/d * invweight,

and the primal problem over accelerations

    min_x 1/2 (x - a0)' M (x - a0) + sum_r active_r min(J_r x - aref_r, 0)^2 / (2 R_r)

solved by a fixed number of Newton iterations from x = a0 = M^-1 qfrc_smooth,
each with a merit line search over six step lengths.

This module is the plain twin of kernel K2a (kernels/csrc/constraint.cuh),
batch axes last.  It runs the kernel's operations in the kernel's order
(sequential sums, the same row order, the same constants), so that on the
card the two round alike: the gates `dist < margin`, `y < 0` and the choice
of step length are branches, and central FD divides any jump by 2 eps.

Rows are sparse: row r touches the dofs `dofs[r]` with coefficients
`coefs[r]` (a limit row has one entry, +1 or -1).  Row order is the JAX
generic engine's: every limited joint's lower side, then every upper side.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.linalg import chol_solve_unrolled, chol_unrolled, sym_solve
from .model import HINGE, SLIDE, Data, Model

NEWTON_ITERS = 8                      # cold start (JAX contact._NEWTON_ITERS)
ALPHA_LADDER = (1.0, 0.5, 0.25, 0.1, 0.04, 0.01)
HESSIAN_JITTER = 1e-10
MAX_INT_POWER = 8

# per limited joint, the constants of its two rows; the kernels read the same
# table from the packed model buffer (kernels/ops.py:pack_model)
LIMIT_FIELDS = ("lo", "hi", "margin", "invweight", "width", "midpoint",
                "den_lo", "den_hi", "d0", "dspan", "b", "kden", "power")


class LimitConstants(NamedTuple):
    joints: Tuple[int, ...]      # limited hinge/slide joints
    qadr: Tuple[int, ...]
    dadr: Tuple[int, ...]
    table: torch.Tensor          # (nlim, len(LIMIT_FIELDS)) on the model's device
    powers: Tuple[float, ...]    # impedance power of each joint

    @property
    def int_power(self) -> bool:
        """Every impedance power is a small integer (the kernels need it)."""
        return all(p == int(p) and p <= MAX_INT_POWER for p in self.powers)


_LIMIT_CACHE: dict = {}


def limit_constants(model: Model) -> LimitConstants:
    """Per-joint row constants, computed once per model in Python doubles.

    Everything that does not depend on the state is folded here (the JAX lane
    engine folds the same Python constants, `dynamics/lanes.py:656-699`), so
    the twin and the kernels start from identical numbers."""
    hit = _LIMIT_CACHE.get(id(model))
    if hit is not None and hit[0] is model:
        return hit[1]
    joints = tuple(j for j in range(model.njnt)
                   if model.jnt_limited[j]
                   and model.jnt_type[j] in (HINGE, SLIDE))
    rng = model.jnt_range.tolist()
    solref = model.jnt_solref.tolist()
    solimp = model.jnt_solimp.tolist()
    margin = model.jnt_margin.tolist()
    invw = model.dof_invweight0.tolist()
    rows = []
    for j in joints:
        d0, dwidth, width, mid, power = solimp[j]
        mp = min(max(mid, 1e-6), 1.0 - 1e-6)
        pw = max(power, 1.0)
        tc = max(solref[j][0], 1e-8)
        dr = max(solref[j][1], 1e-8)
        rows.append([
            rng[j][0], rng[j][1], margin[j],
            max(invw[model.jnt_dofadr[j]], 1e-9),
            max(width, 1e-12), mp, mp ** (pw - 1.0),
            (1.0 - mp) ** (pw - 1.0), d0, dwidth - d0,
            2.0 / (dwidth * tc), dwidth * dwidth * tc * tc * dr * dr, pw])
    table = torch.tensor(rows, dtype=model.dtype, device=model.device).reshape(
        len(joints), len(LIMIT_FIELDS))
    out = LimitConstants(
        joints, tuple(model.jnt_qposadr[j] for j in joints),
        tuple(model.jnt_dofadr[j] for j in joints), table,
        tuple(r[-1] for r in rows))
    if len(_LIMIT_CACHE) > 16:
        _LIMIT_CACHE.clear()
    _LIMIT_CACHE[id(model)] = (model, out)
    return out


class Rows(NamedTuple):
    dofs: Tuple[Tuple[int, ...], ...]     # per row, the dofs it touches
    coefs: Tuple[Tuple[float, ...], ...]  # per row, the J entries there
    aref: torch.Tensor                    # (R, *L)
    R: torch.Tensor                       # (R, *L)
    active: torch.Tensor                  # (R, *L) 1.0 / 0.0


def rows_jacobian(rows: Rows, nv: int) -> torch.Tensor:
    """The dense constraint Jacobian (R, nv) of sparse rows."""
    J = torch.zeros((len(rows.dofs), nv), dtype=rows.aref.dtype,
                    device=rows.aref.device)
    for r, (dofs, coefs) in enumerate(zip(rows.dofs, rows.coefs)):
        for d, c in zip(dofs, coefs):
            J[r, d] = c
    return J


def _impedance(c: dict, pos: torch.Tensor, lc: LimitConstants) -> torch.Tensor:
    """mj_assignImpedance: the power sigmoid from d0 to dwidth over `width`.
    Integer powers multiply out (x, x x, ...) as the kernel does; CUDA's pow
    and torch.pow need not round alike."""
    x = torch.clamp(pos.abs() / c["width"], 0.0, 1.0)

    def power(z):
        if not lc.int_power:
            return z ** c["power"]
        out = z
        for k in range(1, int(max(lc.powers))):
            out = out * z if min(lc.powers) > k else torch.where(
                c["power"] > k, out * z, out)
        return out

    y_lo = power(x) / c["den_lo"]
    y_hi = 1.0 - power(1.0 - x) / c["den_hi"]
    y = torch.where(x <= c["midpoint"], y_lo, y_hi)
    return c["d0"] + y * c["dspan"]


def _limit_rows(model: Model, data: Data) -> Optional[Rows]:
    """Joint-limit rows, two one-sided rows per limited scalar joint:
    dist = q - lo with J = +e, and hi - q with J = -e."""
    lc = limit_constants(model)
    n = len(lc.joints)
    if n == 0:
        return None
    nl = data.qpos.dim() - 1
    # constants as (2n, 1...) tensors: a tensor divisor divides on the card
    # too (a Python scalar divisor becomes a multiply by its reciprocal)
    tab = torch.cat([lc.table, lc.table]).reshape((2 * n, -1) + (1,) * nl)
    c = {f: tab[:, i] for i, f in enumerate(LIMIT_FIELDS)}
    q = data.qpos[list(lc.qadr)]
    v = data.qvel[list(lc.dadr)]
    dist = torch.cat([q - c["lo"][:n], c["hi"][:n] - q])
    vel = torch.cat([v, -v])
    include = dist < c["margin"]
    imp_pos = dist - c["margin"]
    d = _impedance(c, imp_pos, lc)
    k = d / c["kden"]
    aref = (-c["b"]) * vel - k * imp_pos
    R = torch.clamp((1.0 - d) / torch.clamp(d, min=1e-6),
                    min=1e-9) * c["invweight"]
    return Rows(
        dofs=tuple((d_,) for d_ in lc.dadr) * 2,
        coefs=((1.0,),) * n + ((-1.0,),) * n,
        aref=aref, R=R, active=include.to(aref.dtype))


def limits_active(model: Model, qpos: torch.Tensor) -> torch.Tensor:
    """Whether any limit row is active at qpos (nq, *L) -> bool (*L): some
    limited joint lies within its margin of a limit or beyond it."""
    lc = limit_constants(model)
    if not lc.joints:
        return torch.zeros(qpos.shape[1:], dtype=torch.bool,
                           device=qpos.device)
    shape = (len(lc.joints),) + (1,) * (qpos.dim() - 1)
    lo, hi, margin = (lc.table[:, i].reshape(shape) for i in range(3))
    q = qpos[list(lc.qadr)]
    return ((q - lo < margin) | (hi - q < margin)).any(0)


def _contact_rows(model: Model, data: Data) -> Optional[Rows]:
    if model.contact_pairs:
        raise NotImplementedError(
            "contact rows (narrow phase, pyramidal friction) are not ported "
            "yet (ROADMAP Queue 1 item 7b): the model has "
            f"{len(model.contact_pairs)} contact pairs")
    return None


def assemble_constraints(model: Model, data: Data) -> Optional[Rows]:
    parts = [p for p in (_limit_rows(model, data), _contact_rows(model, data))
             if p is not None]
    if not parts:
        return None
    if len(parts) == 1:
        return parts[0]
    return Rows(dofs=sum((p.dofs for p in parts), ()),
                coefs=sum((p.coefs for p in parts), ()),
                aref=torch.cat([p.aref for p in parts]),
                R=torch.cat([p.R for p in parts]),
                active=torch.cat([p.active for p in parts]))


# ---------------------------------------------------------------------------
# the solver, in the kernel's operation order
# ---------------------------------------------------------------------------


def _seq_sum(p: torch.Tensor) -> torch.Tensor:
    """p[0] + p[1] + ... left to right over the first axis."""
    s = p[0]
    for i in range(1, p.shape[0]):
        s = s + p[i]
    return s


def _matvec(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(n, n, *L) @ (n, *L), each row summed left to right."""
    s = M[:, 0] * x[0]
    for m in range(1, x.shape[0]):
        s = s + M[:, m] * x[m]
    return s


def _rows_times(rows: Rows, x: torch.Tensor) -> torch.Tensor:
    """J x (R, *L), each row summed over its entries in order."""
    out = []
    for dofs, coefs in zip(rows.dofs, rows.coefs):
        s = coefs[0] * x[dofs[0]]
        for d, c in zip(dofs[1:], coefs[1:]):
            s = s + c * x[d]
        out.append(s)
    return torch.stack(out)


def _rows_transpose_add(rows: Rows, base, f: torch.Tensor):
    """base (list of nv entries) + J' f, rows added in order."""
    out = list(base)
    for r, (dofs, coefs) in enumerate(zip(rows.dofs, rows.coefs)):
        for d, c in zip(dofs, coefs):
            out[d] = out[d] + c * f[r]
    return out


def _penalty(invR: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_r invR_r min(y_r, 0)^2, left to right."""
    neg = torch.where(y < 0, y, torch.zeros_like(y))
    return _seq_sum(invR * (neg * neg))


def _newton_iterations(M, a0, rows: Rows, invR, n_iters: int,
                       diag: Optional[dict] = None) -> torch.Tensor:
    """`n_iters` projected-Newton iterations from x = a0 (JAX
    `contact._newton_iterations`, `lanes._solve_rows_x`)."""
    nv = a0.shape[0]
    x = a0
    zero = torch.zeros_like(a0[0])
    for _ in range(n_iters):
        y = _rows_times(rows, x) - rows.aref
        gate = torch.where(y < 0, invR, torch.zeros_like(invR))
        e = x - a0
        Me = _matvec(M, e)
        grad = torch.stack(_rows_transpose_add(rows, Me.unbind(0), gate * y))
        H = [[M[i, j] for j in range(nv)] for i in range(nv)]
        for r, (dofs, coefs) in enumerate(zip(rows.dofs, rows.coefs)):
            for d1, c1 in zip(dofs, coefs):
                for d2, c2 in zip(dofs, coefs):
                    H[d1][d2] = H[d1][d2] + (c1 * gate[r]) * c2
        for i in range(nv):
            H[i][i] = H[i][i] + HESSIAN_JITTER
        L = chol_unrolled(torch.stack([torch.stack(row) for row in H]))
        dx = -chol_solve_unrolled(L, grad)

        # merit along x + alpha dx from shared products (JAX contact.py:54-83)
        Jdx = _rows_times(rows, dx)
        Mdx = _matvec(M, dx)
        eMe = _seq_sum(e * Me)
        eMdx = _seq_sum(e * Mdx)
        dMd = _seq_sum(dx * Mdx)
        c0 = 0.5 * eMe + 0.5 * _penalty(invR, y)
        best_c, best_a = None, None
        for al in ALPHA_LADDER:
            cost = (0.5 * (eMe + (2.0 * al) * eMdx + (al * al) * dMd)
                    + 0.5 * _penalty(invR, y + al * Jdx))
            if best_c is None:
                best_c, best_a = cost, zero + al
                continue
            # the first minimum wins; a NaN cost wins over numbers (argmin)
            better = (cost < best_c) | (torch.isnan(cost)
                                        & ~torch.isnan(best_c))
            best_c = torch.where(better, cost, best_c)
            best_a = torch.where(better, zero + al, best_a)
        alpha = torch.where(best_c < c0, best_a, zero)
        if diag is not None:
            diag.setdefault("alpha", []).append(alpha)
        x = x + alpha * dx
    return x


def solve_constraints(model: Model, data: Data, qfrc_smooth: torch.Tensor,
                      diag: Optional[dict] = None) -> Data:
    """Cold-start solve (JAX `solve_constraints` with `data.warmstart`
    unset): fills qfrc_constraint (nv, *L) and qacc, the Newton solution.
    `diag`, when given, receives the rows and each iteration's step length.
    The warm-start path (`contact.py:380-388`) is not ported (ROADMAP)."""
    rows = assemble_constraints(model, data)
    if rows is None:
        return data.replace(qfrc_constraint=torch.zeros_like(qfrc_smooth))
    M = data.qM
    a0 = sym_solve(M, qfrc_smooth)
    invR = rows.active / rows.R          # inactive rows contribute nothing
    if diag is not None:
        diag["rows"] = rows
    x = _newton_iterations(M, a0, rows, invR, NEWTON_ITERS, diag)
    y = _rows_times(rows, x) - rows.aref
    f = (-torch.where(y < 0, y, torch.zeros_like(y))) * invR
    zero = torch.zeros_like(a0[0])
    qfrc = torch.stack(_rows_transpose_add(rows, [zero] * a0.shape[0], f))
    return data.replace(qfrc_constraint=qfrc, qacc=x)
