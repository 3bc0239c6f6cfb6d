"""Model / Data containers (counterpart of `trajoptkp_tpu/dynamics/model.py`).

`Model` keeps the static topology as Python tuples and the numeric
parameters as float64 tensors on one device.  The port has no MJCF parser:
each model travels as data, an `.npz` of the JAX `Model`'s fields written
once from `trajoptkp_tpu.dynamics.mjcf.load_mjcf` and read back with
`model_from_numpy`.  Conventions are MuJoCo's, as in the JAX package:
quaternions wxyz, cdof rows are [angular; linear-at-origin] twists.

Layout: every per-state array keeps its component axis first and the batch
(lane) axes last, e.g. qpos (nq, *L), so one lane's data is strided by the
lane count — the coalesced layout of the one-thread-per-lane kernels.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

FREE = 0
BALL = 1
SLIDE = 2
HINGE = 3

_DOF_WIDTH = {FREE: 6, BALL: 3, SLIDE: 1, HINGE: 1}

MODELS_DIR = os.path.join(os.path.dirname(__file__), "..", "models")


def dof_width(jnt_type: int) -> int:
    return _DOF_WIDTH[jnt_type]


# fields of the JAX Model carried across, by kind
INT_FIELDS = ("nq", "nv", "nu", "nbody", "njnt", "ngeom", "nsite")
INT_TUPLE_FIELDS = (
    "body_parent", "jnt_type", "jnt_bodyid", "jnt_qposadr", "jnt_dofadr",
    "actuator_trnid", "geom_type", "geom_bodyid", "site_bodyid",
)
BOOL_TUPLE_FIELDS = ("jnt_limited", "actuator_ctrllimited")
NAME_FIELDS = (
    "joint_names", "body_names", "actuator_names", "geom_names", "site_names",
)
STR_FIELDS = ("integrator", "source_xml")
ARRAY_FIELDS = (
    "qpos0", "qpos_spring", "body_pos", "body_quat", "body_ipos",
    "body_iquat", "body_mass", "body_inertia", "jnt_pos", "jnt_axis",
    "jnt_range", "jnt_stiffness", "jnt_solref", "jnt_solimp", "jnt_margin",
    "dof_damping", "dof_armature", "dof_frictionloss", "dof_invweight0",
    "body_invweight0", "actuator_gear", "actuator_ctrlrange",
    "actuator_forcerange", "geom_pos", "geom_quat", "geom_size",
    "geom_friction", "geom_solref", "geom_solimp", "geom_margin",
    "site_pos", "site_quat", "gravity", "timestep", "ancestor_mask",
    "dof_dot_mask",
)


@dataclasses.dataclass(frozen=True)
class Model:
    """Static mechanism description."""

    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    body_parent: Tuple[int, ...]
    jnt_type: Tuple[int, ...]
    jnt_bodyid: Tuple[int, ...]
    jnt_qposadr: Tuple[int, ...]
    jnt_dofadr: Tuple[int, ...]
    jnt_limited: Tuple[bool, ...]
    actuator_trnid: Tuple[int, ...]
    actuator_ctrllimited: Tuple[bool, ...]
    geom_type: Tuple[int, ...]
    geom_bodyid: Tuple[int, ...]
    site_bodyid: Tuple[int, ...]
    contact_pairs: Tuple[Tuple[int, int], ...]
    joint_names: Tuple[str, ...]
    body_names: Tuple[str, ...]
    actuator_names: Tuple[str, ...]
    geom_names: Tuple[str, ...]
    site_names: Tuple[str, ...]
    integrator: str
    source_xml: Optional[str]
    qpos0: torch.Tensor               # (nq,)
    qpos_spring: torch.Tensor         # (nq,)
    body_pos: torch.Tensor            # (nbody, 3)
    body_quat: torch.Tensor           # (nbody, 4)
    body_ipos: torch.Tensor           # (nbody, 3)
    body_iquat: torch.Tensor          # (nbody, 4)
    body_mass: torch.Tensor           # (nbody,)
    body_inertia: torch.Tensor        # (nbody, 3)
    jnt_pos: torch.Tensor             # (njnt, 3)
    jnt_axis: torch.Tensor            # (njnt, 3)
    jnt_range: torch.Tensor           # (njnt, 2)
    jnt_stiffness: torch.Tensor       # (njnt,)
    jnt_solref: torch.Tensor          # (njnt, 2)
    jnt_solimp: torch.Tensor          # (njnt, 5)
    jnt_margin: torch.Tensor          # (njnt,)
    dof_damping: torch.Tensor         # (nv,)
    dof_armature: torch.Tensor        # (nv,)
    dof_frictionloss: torch.Tensor    # (nv,)
    dof_invweight0: torch.Tensor      # (nv,)
    body_invweight0: torch.Tensor     # (nbody, 2)
    actuator_gear: torch.Tensor       # (nu, 6)
    actuator_ctrlrange: torch.Tensor  # (nu, 2)
    actuator_forcerange: torch.Tensor  # (nu, 2)
    geom_pos: torch.Tensor            # (ngeom, 3)
    geom_quat: torch.Tensor           # (ngeom, 4)
    geom_size: torch.Tensor           # (ngeom, 3)
    geom_friction: torch.Tensor       # (ngeom, 3)
    geom_solref: torch.Tensor         # (ngeom, 2)
    geom_solimp: torch.Tensor         # (ngeom, 5)
    geom_margin: torch.Tensor         # (ngeom,)
    site_pos: torch.Tensor            # (nsite, 3)
    site_quat: torch.Tensor           # (nsite, 4)
    gravity: torch.Tensor             # (3,)
    timestep: torch.Tensor            # ()
    ancestor_mask: torch.Tensor       # (nbody, nv) dof on the body's root path
    dof_dot_mask: torch.Tensor        # (nv, nv) dof j drives d/dt cdof_i

    @property
    def dtype(self) -> torch.dtype:
        return self.body_pos.dtype

    @property
    def device(self) -> torch.device:
        return self.body_pos.device

    @property
    def has_constraints(self) -> bool:
        return bool(self.contact_pairs) or any(self.jnt_limited)

    def replace(self, **changes) -> "Model":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class Data:
    """Dynamic state plus the forward() products, batch axes last."""

    qpos: torch.Tensor                    # (nq, *L)
    qvel: torch.Tensor                    # (nv, *L)
    ctrl: torch.Tensor                    # (nu, *L)
    xpos: Optional[torch.Tensor] = None   # (nbody, 3, *L)
    xquat: Optional[torch.Tensor] = None  # (nbody, 4, *L)
    xipos: Optional[torch.Tensor] = None  # (nbody, 3, *L)
    ximat: Optional[torch.Tensor] = None  # (nbody, 3, 3, *L)
    site_xpos: Optional[torch.Tensor] = None  # (nsite, 3, *L)
    site_xmat: Optional[torch.Tensor] = None  # (nsite, 3, 3, *L)
    cdof: Optional[torch.Tensor] = None   # (nv, 6, *L)
    cinert: Optional[torch.Tensor] = None  # (nbody, 10, *L) m, m c, J
    qfrc_bias: Optional[torch.Tensor] = None      # (nv, *L)
    qfrc_passive: Optional[torch.Tensor] = None   # (nv, *L)
    qfrc_actuator: Optional[torch.Tensor] = None  # (nv, *L)
    qfrc_constraint: Optional[torch.Tensor] = None  # (nv, *L)
    qM: Optional[torch.Tensor] = None     # (nv, nv, *L)
    qacc: Optional[torch.Tensor] = None   # (nv, *L)

    def replace(self, **changes) -> "Data":
        return dataclasses.replace(self, **changes)


def model_from_numpy(d, dtype=torch.float64, device=None) -> Model:
    """Build a Model from the JAX Model's fields given as numpy arrays.

    `d` maps field name -> numpy array (an open `.npz` works): integer and
    boolean tuples as 1-D arrays, `contact_pairs` as (npair, 2), names as
    string arrays, `integrator`/`source_xml` as 0-d string arrays (an empty
    `source_xml` means none)."""
    device = resolve_device(device)
    kw = {}
    for f in INT_FIELDS:
        kw[f] = int(np.asarray(d[f]))
    for f in INT_TUPLE_FIELDS:
        kw[f] = tuple(int(x) for x in np.asarray(d[f]).reshape(-1))
    for f in BOOL_TUPLE_FIELDS:
        kw[f] = tuple(bool(x) for x in np.asarray(d[f]).reshape(-1))
    for f in NAME_FIELDS:
        kw[f] = tuple(str(x) for x in np.asarray(d[f]).reshape(-1))
    pairs = np.asarray(d["contact_pairs"]).reshape(-1, 2)
    kw["contact_pairs"] = tuple((int(a), int(b)) for a, b in pairs)
    kw["integrator"] = str(np.asarray(d["integrator"]))
    src = str(np.asarray(d["source_xml"]))
    kw["source_xml"] = src or None
    for f in ARRAY_FIELDS:
        kw[f] = torch.as_tensor(np.asarray(d[f], dtype=np.float64),
                                dtype=dtype, device=device)
    return Model(**kw)


def load_model(name: str, dtype=torch.float64, device=None) -> Model:
    """Read the checked-in `models/{name}.npz` (acrobot, pentabot, panda,
    push_ncl)."""
    path = os.path.join(MODELS_DIR, f"{name}.npz")
    if not os.path.exists(path):
        have = sorted(f[:-4] for f in os.listdir(MODELS_DIR)
                      if f.endswith(".npz"))
        raise FileNotFoundError(f"no model {name!r}; the port carries {have}")
    with np.load(path, allow_pickle=False) as z:
        return model_from_numpy(z, dtype=dtype, device=device)
