"""The topology tables of a kernel instance, as csrc/instances.cuh holds
them: one struct of C++17 `static constexpr` arrays per instance, sized by
the instance, which step.cuh's `Topo` reads at compile time.  `emit` writes
an instance's struct and its X entry, `parse` reads every instance back
from the header's text; kernels/ops.py computes a task's tables
(`ops.instance_key`) and kernels/build.py groups the instances by them.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Tuple


class Topology(NamedTuple):
    """Sizes; per body (world first): its parent, first dof (-1 for none),
    number of dofs, first joint's first qpos (0 for none) and whether its
    joint is free; per dof: whether its joint is a slide, whether it is
    limited, its body and its qpos (a free joint's rotation dofs continue
    its translations' count); per state dof its qvel index; per contact
    pair its geom types and bodies; the residual kind (residuals.cuh RES_*)
    and its arguments."""

    NV: int
    NU: int
    NBODY: int
    NDOF: int
    PARENT: Tuple[int, ...]
    BODY_DOF: Tuple[int, ...]
    BODY_NDOF: Tuple[int, ...]
    BODY_QADR: Tuple[int, ...]
    FREE: Tuple[int, ...]
    SLIDE: Tuple[int, ...]
    LIMITED: Tuple[int, ...]
    DOF_BODY: Tuple[int, ...]
    DOF_Q: Tuple[int, ...]
    SV: Tuple[int, ...]
    PAIRS: Tuple[Tuple[int, int, int, int], ...]
    RES: int
    RESARGS: Tuple[int, ...]

    def step_only(self) -> "Topology":
        """The tables without the residual: what the step alone reads."""
        return self._replace(RES=-1, RESARGS=())


SCALARS = ("NV", "NU", "NBODY", "NDOF", "RES")
ARRAYS = ("PARENT", "BODY_DOF", "BODY_NDOF", "BODY_QADR", "FREE", "SLIDE",
          "LIMITED", "DOF_BODY", "DOF_Q", "SV", "RESARGS")


def _ints(xs) -> str:
    return ", ".join(str(int(x)) for x in xs)


def emit(tag: str, topo: Topology) -> str:
    """The instances.cuh struct and X entry of one instance.  An empty
    table keeps one unused entry (C++ has no arrays of size 0); NPAIR says
    how many pairs there are."""
    lines = [f"struct Topo_{tag} {{"]
    for name in SCALARS[:4]:
        lines.append(f"  static constexpr int {name} = {getattr(topo, name)};")
    lines.append(f"  static constexpr int NPAIR = {len(topo.PAIRS)};")
    lines.append(f"  static constexpr int RES = {topo.RES};")
    for name in ARRAYS:
        vals = getattr(topo, name)
        lines.append(f"  static constexpr int {name}[{max(len(vals), 1)}] = "
                     f"{{{_ints(vals) if vals else 0}}};")
    pairs = topo.PAIRS or ((0, 0, 0, 0),)
    body = ", ".join("{" + _ints(p) + "}" for p in pairs)
    lines.append(f"  static constexpr int PAIRS[{len(pairs)}][4] = {{{body}}};")
    lines.append("};")
    lines.append(f"#define TRAJOPT_MODEL_{tag}(X) X({tag}, Topo_{tag})")
    return "\n".join(_wrap(ln) for ln in lines)


def _wrap(line: str, width: int = 79) -> str:
    """Break a long table line after commas (clang-format's layout)."""
    if len(line) <= width:
        return line
    head, _, rest = line.partition("= {")
    out, cur = [], head + "= {"
    for word in rest.split(" "):
        if len(cur) + 1 + len(word) > width:
            out.append(cur.rstrip())
            cur = "      " + word
        else:
            cur = cur + ("" if cur.endswith("{") else " ") + word
    out.append(cur)
    return "\n".join(out)


_STRUCT = re.compile(r"struct\s+Topo_(\w+)\s*\{(.*?)\n\};", re.S)
_SCALAR = re.compile(r"static\s+constexpr\s+int\s+(\w+)\s*=\s*(-?\d+)\s*;")
_ARRAY = re.compile(
    r"static\s+constexpr\s+int\s+(\w+)\s*\[\s*\d+\s*\]\s*=\s*\{([^{}]*)\}\s*;")
_PAIRS = re.compile(r"PAIRS\s*\[\s*\d+\s*\]\s*\[\s*4\s*\]\s*=\s*\{(.*)\}\s*;",
                    re.S)


def parse(text: str) -> dict:
    """tag -> Topology of every instance struct in instances.cuh's text."""
    out = {}
    for tag, body in _STRUCT.findall(text):
        sc = {k: int(v) for k, v in _SCALAR.findall(body)}
        ar = {k: tuple(int(x) for x in v.replace("\n", " ").split(",")
                       if x.strip())
              for k, v in _ARRAY.findall(body)}
        rows = re.findall(r"\{([^{}]*)\}", _PAIRS.search(body).group(1))
        pairs = tuple(tuple(int(x) for x in r.split(",")) for r in rows)
        n = {"PARENT": sc["NBODY"], "BODY_DOF": sc["NBODY"],
             "BODY_NDOF": sc["NBODY"], "BODY_QADR": sc["NBODY"],
             "FREE": sc["NBODY"], "SLIDE": sc["NV"], "LIMITED": sc["NV"],
             "DOF_BODY": sc["NV"], "DOF_Q": sc["NV"], "SV": sc["NDOF"],
             "RESARGS": len(ar["RESARGS"])}
        out[tag] = Topology(
            **{k: sc[k] for k in SCALARS},
            **{k: ar[k][:n[k]] for k in ARRAYS},
            PAIRS=pairs[:sc["NPAIR"]])
    return out
