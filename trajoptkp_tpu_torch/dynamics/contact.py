"""Soft-constraint rows and their solver (counterpart of
`trajoptkp_tpu/dynamics/contact.py`): joint-limit rows, pyramidal contact
rows from the narrow phase (dynamics/collision.py) and the cold-start
projected-Newton solve.

MuJoCo's constraint model, as in the JAX package: impedance d(pos) from
solimp, stiffness and damping from solref,

    b = 2 / (dmax tc),  k = d / (dmax^2 tc^2 dr^2),
    aref = -b (J qvel) - k (dist - margin),  R = (1 - d)/d * invweight,

and the primal problem over accelerations

    min_x 1/2 (x - a0)' M (x - a0) + sum_r active_r min(J_r x - aref_r, 0)^2 / (2 R_r)

solved by a fixed number of Newton iterations from x = a0 = M^-1 qfrc_smooth,
each with a merit line search over six step lengths.

This module is the plain twin of kernels K2a (kernels/csrc/constraint.cuh)
and K2b (kernels/csrc/contact.cuh), batch axes last.  It runs the kernels'
operations in their order (sequential sums, the same row order, the same
constants), so that on the card the two round alike: the gates
`dist < margin`, `y < 0` and the choice of step length are branches, and
central FD divides any jump by 2 eps.

Rows are sparse: limit row r touches the dof `dofs[r]` with coefficient
+1 or -1; the rows of a contact pair share its support, the dofs on exactly
one of the two bodies' root paths, with per-lane coefficients (a `PairRows`
block).  Row order: every limited joint's lower side, then every upper side
(the JAX generic engine's), then the contact rows, pair by pair, slot by
slot, four per slot: Jn + mu Jt1, Jn - mu Jt1, Jn + mu Jt2, Jn - mu Jt2
(the JAX lane engine's, `dynamics/lanes.py:989`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import math as tm
from ..utils.linalg import chol_solve_unrolled, chol_unrolled, sym_solve
from .collision import geom_pose, pair_contacts, pair_ncon
from .fk import forward_kinematics
from .model import HINGE, SLIDE, Data, Model

NEWTON_ITERS = 8                      # cold start (JAX contact._NEWTON_ITERS)
ALPHA_LADDER = (1.0, 0.5, 0.25, 0.1, 0.04, 0.01)
HESSIAN_JITTER = 1e-10
MAX_INT_POWER = 8

# per limited joint, the constants of its two rows; the kernels read the same
# table from the packed model buffer (kernels/ops.py:pack_model)
LIMIT_FIELDS = ("lo", "hi", "margin", "invweight", "width", "midpoint",
                "den_lo", "den_hi", "d0", "dspan", "b", "kden", "power")
# per contact pair, likewise; the impedance fields sit where LIMIT_FIELDS has
# them, so one impedance function reads both tables
CONTACT_FIELDS = ("mu", "unused", "margin", "rconst", "width", "midpoint",
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
        rows.append([rng[j][0], rng[j][1], margin[j],
                     max(invw[model.jnt_dofadr[j]], 1e-9)]
                    + _impedance_constants(solref[j], solimp[j]))
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


def _impedance_constants(solref, solimp):
    """width, midpoint, den_lo, den_hi, d0, dspan, b, kden, power from one
    row's solref/solimp (JAX `_impedance`, `_kb`), in Python doubles."""
    d0, dwidth, width, mid, power = solimp
    mp = min(max(mid, 1e-6), 1.0 - 1e-6)
    pw = max(power, 1.0)
    tc = max(solref[0], 1e-8)
    dr = max(solref[1], 1e-8)
    return [max(width, 1e-12), mp, mp ** (pw - 1.0), (1.0 - mp) ** (pw - 1.0),
            d0, dwidth - d0, 2.0 / (dwidth * tc),
            dwidth * dwidth * tc * tc * dr * dr, pw]


def root_path_dofs(model: Model, b: int) -> Tuple[int, ...]:
    """The dofs on body b's root path (its own included)."""
    anc = model.ancestor_mask[b].tolist()
    return tuple(i for i in range(model.nv) if anc[i] > 0.5)


class Pair(NamedTuple):
    g1: int
    g2: int
    types: Tuple[int, int]
    bodies: Tuple[int, int]
    sizes: Tuple[Tuple[float, ...], Tuple[float, ...]]
    ncon: int
    support: Tuple[int, ...]     # dofs on exactly one of the root paths
    signs: Tuple[float, ...]     # +1 on geom2's body path, -1 on geom1's


class ContactConstants(NamedTuple):
    pairs: Tuple[Pair, ...]
    table: torch.Tensor          # (npair, len(CONTACT_FIELDS))
    powers: Tuple[float, ...]

    @property
    def int_power(self) -> bool:
        return all(p == int(p) and p <= MAX_INT_POWER for p in self.powers)

    @property
    def nslot(self) -> int:
        return sum(p.ncon for p in self.pairs)


_CONTACT_CACHE: dict = {}


def contact_constants(model: Model) -> ContactConstants:
    """Static pair data and per-pair row constants, once per model.

    MuJoCo's default mixing (equal priority, solmix 1) as JAX `_combine`:
    solref and solimp averaged, friction and margin the larger; R's constant
    factor max(invw1 + invw2, 1e-9) 2 mu^2 (1 + mu^2) is folded here in
    Python doubles, and the kernels read the same table."""
    hit = _CONTACT_CACHE.get(id(model))
    if hit is not None and hit[0] is model:
        return hit[1]
    size = model.geom_size.tolist()
    solref = model.geom_solref.tolist()
    solimp = model.geom_solimp.tolist()
    fric = model.geom_friction.tolist()
    gmargin = model.geom_margin.tolist()
    invw = model.body_invweight0.tolist()
    pairs, rows = [], []
    for g1, g2 in model.contact_pairs:
        t = (model.geom_type[g1], model.geom_type[g2])
        b = (model.geom_bodyid[g1], model.geom_bodyid[g2])
        p1, p2 = root_path_dofs(model, b[0]), root_path_dofs(model, b[1])
        support = tuple(i for i in range(model.nv) if (i in p1) != (i in p2))
        pairs.append(Pair(g1, g2, t, b, (tuple(size[g1]), tuple(size[g2])),
                          pair_ncon(*t), support,
                          tuple(1.0 if i in p2 else -1.0 for i in support)))
        ref = [0.5 * (solref[g1][k] + solref[g2][k]) for k in range(2)]
        imp = [0.5 * (solimp[g1][k] + solimp[g2][k]) for k in range(5)]
        mu = max(fric[g1][0], fric[g2][0])
        margin = max(gmargin[g1], gmargin[g2])
        rconst = (max(invw[b[0]][0] + invw[b[1]][0], 1e-9)
                  * (2.0 * mu * mu * (1.0 + mu * mu)))
        rows.append([mu, 0.0, margin, rconst]
                    + _impedance_constants(ref, imp))
    table = torch.tensor(rows, dtype=model.dtype, device=model.device).reshape(
        len(pairs), len(CONTACT_FIELDS))
    out = ContactConstants(tuple(pairs), table, tuple(r[-1] for r in rows))
    if len(_CONTACT_CACHE) > 16:
        _CONTACT_CACHE.clear()
    _CONTACT_CACHE[id(model)] = (model, out)
    return out


class PairRows(NamedTuple):
    """The 4 ncon rows of one contact pair over its shared support."""

    support: Tuple[int, ...]
    coef: torch.Tensor            # (4 ncon, len(support), *L)


class Rows(NamedTuple):
    dofs: Tuple[Tuple[int, ...], ...]     # per limit row, the dofs it touches
    coefs: Tuple[Tuple[float, ...], ...]  # per limit row, the J entries there
    aref: torch.Tensor                    # (R, *L), limit rows then contacts
    R: torch.Tensor                       # (R, *L)
    active: torch.Tensor                  # (R, *L) 1.0 / 0.0
    pairs: Tuple[PairRows, ...] = ()      # contact rows after the limit rows


def rows_jacobian(rows: Rows, nv: int) -> torch.Tensor:
    """The dense constraint Jacobian of sparse rows: (R, nv) for limit rows
    alone, whose coefficients are constants, (R, nv, *L) once contact rows,
    whose coefficients vary per lane, are among them."""
    lanes = tuple(rows.aref.shape[1:]) if rows.pairs else ()
    J = torch.zeros((rows.aref.shape[0], nv) + lanes,
                    dtype=rows.aref.dtype, device=rows.aref.device)
    for r, (dofs, coefs) in enumerate(zip(rows.dofs, rows.coefs)):
        for d, c in zip(dofs, coefs):
            J[r, d] = c
    r0 = len(rows.dofs)
    for blk in rows.pairs:
        n = blk.coef.shape[0]
        J[r0:r0 + n, list(blk.support)] = blk.coef
        r0 += n
    return J


def _impedance(c: dict, pos: torch.Tensor, lc) -> torch.Tensor:
    """mj_assignImpedance: the power sigmoid from d0 to dwidth over `width`.
    Integer powers multiply out (x, x x, ...) as the kernel does; CUDA's pow
    and torch.pow need not round alike.  `lc` holds the rows' powers
    (LimitConstants or ContactConstants)."""
    x = tm.clip(pos.abs() / c["width"], 0.0, 1.0)

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
    R = tm.at_least((1.0 - d) / tm.at_least(d, 1e-6),
                    1e-9) * c["invweight"]
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


def _cross_rows(w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """w x p for w (W, 3, *L) and a point p (3, *L), as tm.cross per row."""
    return torch.stack([w[:, 1] * p[2] - w[:, 2] * p[1],
                        w[:, 2] * p[0] - w[:, 0] * p[2],
                        w[:, 0] * p[1] - w[:, 1] * p[0]], 1)


def contact_slots(model: Model, data: Data):
    """The narrow phase of every pair: a list of collision.Slots."""
    cc = contact_constants(model)
    out = []
    for pr in cc.pairs:
        xp1, xm1 = geom_pose(model, data, pr.g1)
        xp2, xm2 = geom_pose(model, data, pr.g2)
        out.append(pair_contacts(*pr.types, xp1, xm1, pr.sizes[0], xp2, xm2,
                                 pr.sizes[1]))
    return out


def _contact_rows(model: Model, data: Data) -> Optional[Rows]:
    """Pyramidal rows of every contact slot (JAX `_contact_rows`), four per
    slot: J = Jn +- mu Jt1, Jn +- mu Jt2 with the relative point Jacobian
    (cdof_lin + cdof_ang x pos) signed +1 on geom2's path and -1 on
    geom1's; aref = -b (J qvel) - k (dist - margin); one R per slot,
    R = max((1 - d) / max(d, 1e-6), 1e-9) rconst; gate dist < margin."""
    if not model.contact_pairs:
        return None
    cc = contact_constants(model)
    v = data.qvel
    nl = v.dim() - 1
    blocks, arefs, Rs, acts = [], [], [], []
    for p, (pr, slots) in enumerate(zip(cc.pairs, contact_slots(model,
                                                                data))):
        c = {f: cc.table[p, i] for i, f in enumerate(CONTACT_FIELDS)}
        mu = float(cc.table[p, 0])
        S = list(pr.support)
        sgn = torch.tensor(pr.signs, dtype=v.dtype, device=v.device).reshape(
            (-1, 1) + (1,) * nl)
        cw, cl = data.cdof[S, :3], data.cdof[S, 3:]      # (W, 3, *L)
        f0, f1, f2 = slots.frame
        coefs = []
        for dist, pos in zip(slots.dist, slots.pos):
            include = dist < c["margin"]
            imp = dist - c["margin"]
            d = _impedance(c, imp, cc)
            k = d / c["kden"]
            R = tm.at_least((1.0 - d) / tm.at_least(d, 1e-6),
                            1e-9) * c["rconst"]
            jac = (cl + _cross_rows(cw, pos)) * sgn          # (W, 3, *L)
            Jn, Jt1, Jt2 = ((f[0] * jac[:, 0] + f[1] * jac[:, 1])
                            + f[2] * jac[:, 2] for f in (f0, f1, f2))
            for Jt in (Jt1, Jt2):
                for smu in (mu, -mu):
                    coef = Jn + smu * Jt                     # (W, *L)
                    vel = coef[0] * v[S[0]]
                    for w in range(1, len(S)):
                        vel = vel + coef[w] * v[S[w]]
                    coefs.append(coef)
                    arefs.append((-c["b"]) * vel - k * imp)
                    Rs.append(R)
                    acts.append(include.to(v.dtype))
        blocks.append(PairRows(pr.support, torch.stack(coefs)))
    return Rows(dofs=(), coefs=(), aref=torch.stack(arefs), R=torch.stack(Rs),
                active=torch.stack(acts), pairs=tuple(blocks))


def contacts_active(model: Model, qpos: torch.Tensor):
    """Per pair, whether any of its slots is within its margin at qpos
    (nq, *L): bool (npair, *L)."""
    cc = contact_constants(model)
    lanes = tuple(qpos.shape[1:])
    data = forward_kinematics(model, Data(
        qpos=qpos, qvel=torch.zeros((model.nv,) + lanes, dtype=qpos.dtype,
                                    device=qpos.device),
        ctrl=torch.zeros((model.nu,) + lanes, dtype=qpos.dtype,
                         device=qpos.device)))
    out = []
    for p, slots in enumerate(contact_slots(model, data)):
        margin = cc.table[p, 2]
        out.append(torch.stack([d < margin for d in slots.dist]).any(0))
    return torch.stack(out)


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
                active=torch.cat([p.active for p in parts]),
                pairs=sum((p.pairs for p in parts), ()))


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
    for blk in rows.pairs:
        s = blk.coef[:, 0] * x[blk.support[0]]
        for w in range(1, len(blk.support)):
            s = s + blk.coef[:, w] * x[blk.support[w]]
        out.append(s)
    out = [o[None] if o.dim() == x.dim() - 1 else o for o in out]
    return torch.cat(out)


def _rows_transpose_add(rows: Rows, base, f: torch.Tensor):
    """base (list of nv entries) + J' f (nv, *L), rows added in order."""
    out = list(base)
    for r, (dofs, coefs) in enumerate(zip(rows.dofs, rows.coefs)):
        for d, c in zip(dofs, coefs):
            out[d] = out[d] + c * f[r]
    out = torch.stack(out)
    r = len(rows.dofs)
    for blk in rows.pairs:
        idx = torch.tensor(blk.support, device=f.device)
        for row in range(blk.coef.shape[0]):
            out = out.index_put((idx,), out[idx] + blk.coef[row] * f[r])
            r += 1
    return out


def _hessian(rows: Rows, M: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """M + J' diag(gate) J + jitter I, row by row in order, as the kernel."""
    nv = M.shape[0]
    H = [[M[i, j] for j in range(nv)] for i in range(nv)]
    for r, (dofs, coefs) in enumerate(zip(rows.dofs, rows.coefs)):
        for d1, c1 in zip(dofs, coefs):
            for d2, c2 in zip(dofs, coefs):
                H[d1][d2] = H[d1][d2] + (c1 * gate[r]) * c2
    if rows.pairs:
        H = torch.stack([torch.stack(row) for row in H])
        r = len(rows.dofs)
        for blk in rows.pairs:
            idx = torch.tensor(blk.support, device=M.device)
            ii, jj = idx[:, None], idx[None, :]
            for row in range(blk.coef.shape[0]):
                c = blk.coef[row]
                upd = (c[:, None] * gate[r]) * c[None, :]
                H = H.index_put((ii, jj), H[ii, jj] + upd)
                r += 1
        H = [list(row.unbind(0)) for row in H.unbind(0)]
    for i in range(nv):
        H[i][i] = H[i][i] + HESSIAN_JITTER
    return torch.stack([torch.stack(row) for row in H])


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
        grad = _rows_transpose_add(rows, Me.unbind(0), gate * y)
        L = chol_unrolled(_hessian(rows, M, gate))
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


class _RowShape(NamedTuple):
    """The static part of `Rows` (every row's dofs, the limit rows' constant
    coefficients, each contact block's support): with the tensors aref and
    the blocks' coefficients it rebuilds the rows inside `_NewtonSolve`,
    whose tensors must all be arguments of its own."""

    dofs: Tuple[Tuple[int, ...], ...]
    coefs: Tuple[Tuple[float, ...], ...]
    supports: Tuple[Tuple[int, ...], ...]

    def rows(self, aref, blocks) -> Rows:
        return Rows(dofs=self.dofs, coefs=self.coefs, aref=aref, R=None,
                    active=None,
                    pairs=tuple(PairRows(s, c)
                                for s, c in zip(self.supports, blocks)))


def implicit_residual_tangent(shape: _RowShape, x, primals, tangents):
    """dF, the tangent of the optimality residual
    F(x; θ) = M (x - a0) + J' (min(y, 0) invR), y = J x - aref, at a fixed
    x over θ = (M, a0, aref, invR, the contact blocks' coefficients) (JAX
    `_solve_rows_x_jvp`: `Rres`).  Each product's tangent is
    b' a + a' b and each sum runs in the order kernel K2c
    (csrc/constraint.cuh: implicit_tangent) evaluates F in dual numbers;
    a limit row's coefficient is a constant."""
    M, a0, aref, invR, *blocks = primals
    dM, da0, daref, dinvR, *dblocks = tangents
    e, de = x - a0, -da0
    ds = de[0] * M[:, 0] + dM[:, 0] * e[0]
    for m in range(1, x.shape[0]):
        ds = ds + (de[m] * M[:, m] + dM[:, m] * e[m])
    out = list(ds.unbind(0))
    rows = shape.rows(aref, blocks)
    drows = Rows(dofs=shape.dofs, coefs=tuple((0.0,) * len(c)
                                              for c in shape.coefs),
                 aref=daref, R=None, active=None,
                 pairs=tuple(PairRows(s_, c) for s_, c in
                             zip(shape.supports, dblocks)))
    y = _rows_times(rows, x) - aref
    dy = _rows_times(drows, x) - daref
    neg = y < 0
    w = torch.where(neg, y, torch.zeros_like(y))
    dw = torch.where(neg, dy, torch.zeros_like(dy))
    f = w * invR
    df = dinvR * w + dw * invR
    for r, (dofs, coefs) in enumerate(zip(shape.dofs, shape.coefs)):
        for d, c in zip(dofs, coefs):
            out[d] = out[d] + df[r] * c
    out = torch.stack(out)
    r = len(shape.dofs)
    for blk, dblk in zip(rows.pairs, drows.pairs):
        idx = torch.tensor(blk.support, device=x.device)
        for row in range(blk.coef.shape[0]):
            out = out.index_put((idx,), out[idx] + (df[r] * blk.coef[row]
                                                    + dblk.coef[row] * f[r]))
            r += 1
    return out


class _NewtonSolve(torch.autograd.Function):
    """x = `_newton_iterations` (the primal projected-Newton solve), with
    the implicit-function tangent at the iterate it returns (JAX
    `contact._newton_solver:95-135`, `lanes._solve_rows_x_jvp:1490`,
    `_solve_rows_x_regs_jvp:1309`): dx = -(H + 1e-10 I)^-1 dF with
    H = M + J' G J gated at x and dF the tangent of `implicit_residual`
    over M, a0, aref, invR and the contact rows' coefficients
    (`implicit_residual_tangent`).  The
    iterations are not differentiated: at a stiff row 8 cold iterations
    have not converged, and the rule is taken at the iterate, as JAX's.
    This is the plain version of K2c."""

    generate_vmap_rule = True

    @staticmethod
    def forward(shape, M, a0, aref, invR, *blocks):
        return _newton_iterations(M, a0, shape.rows(aref, blocks), invR,
                                  NEWTON_ITERS)

    @staticmethod
    def setup_context(ctx, inputs, output):
        shape, M, a0, aref, invR, *blocks = inputs
        ctx.shape = shape
        ctx.save_for_forward(output, M, a0, aref, invR, *blocks)

    @staticmethod
    def jvp(ctx, _, dM, da0, daref, dinvR, *dblocks):
        x, M, a0, aref, invR, *blocks = ctx.saved_tensors
        shape = ctx.shape
        primals = (M, a0, aref, invR, *blocks)
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip(primals, (dM, da0, daref, dinvR,
                                                   *dblocks)))
        dF = implicit_residual_tangent(shape, x, primals, tangents)
        rows = shape.rows(aref, blocks)
        y = _rows_times(rows, x) - aref
        gate = torch.where(y < 0, invR, torch.zeros_like(invR))
        return -chol_solve_unrolled(chol_unrolled(_hessian(rows, M, gate)),
                                    dF)


def newton_solve(M, a0, rows: Rows, invR) -> torch.Tensor:
    """The Newton solution x of the rows' problem, differentiated
    implicitly (`_NewtonSolve`)."""
    shape = _RowShape(rows.dofs, rows.coefs,
                      tuple(blk.support for blk in rows.pairs))
    return _NewtonSolve.apply(shape, M, a0, rows.aref, invR,
                              *(blk.coef for blk in rows.pairs))


def solve_constraints(model: Model, data: Data, qfrc_smooth: torch.Tensor,
                      diag: Optional[dict] = None) -> Data:
    """Cold-start solve (JAX `solve_constraints` with `data.warmstart`
    unset): fills qfrc_constraint (nv, *L) and qacc, the Newton solution,
    whose tangent is the implicit one (`newton_solve`); the force is
    recomputed from x outside that rule, as JAX `lanes._solve_rows:1523`
    does, so that its gating differentiates with it.  `diag`, when given,
    receives the rows and each iteration's step length (the iterations are
    then run as they are, without the implicit rule).  The warm-start path
    (`contact.py:380-388`) is not ported (ROADMAP)."""
    rows = assemble_constraints(model, data)
    if rows is None:
        return data.replace(qfrc_constraint=torch.zeros_like(qfrc_smooth))
    M = data.qM
    a0 = sym_solve(M, qfrc_smooth)
    invR = rows.active / rows.R          # inactive rows contribute nothing
    if diag is not None:
        diag["rows"] = rows
        x = _newton_iterations(M, a0, rows, invR, NEWTON_ITERS, diag)
    else:
        x = newton_solve(M, a0, rows, invR)
    y = _rows_times(rows, x) - rows.aref
    f = (-torch.where(y < 0, y, torch.zeros_like(y))) * invR
    zero = torch.zeros_like(a0[0])
    qfrc = _rows_transpose_add(rows, [zero] * a0.shape[0], f)
    return data.replace(qfrc_constraint=qfrc, qacc=x)
