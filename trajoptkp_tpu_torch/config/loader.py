"""Task registry (counterpart of `trajoptkp_tpu/config/loader.py`).

Only the ported tasks.  No YAML/CSV config: the machine with the card has no
`yaml`, and the config layer is part of ROADMAP's harness, config, CLI and
bench work.
"""

from __future__ import annotations

import functools

from ..tasks.locomotion import make_walker
from ..tasks.manipulation import make_box_sweep, make_threed_push
from ..tasks.pushing import make_pushing
from ..tasks.reaching import make_reaching
from ..tasks.toys import make_acrobot, make_pentabot

_REGISTRY = {
    "acrobot": make_acrobot,
    "pentabot": make_pentabot,
    "reaching": make_reaching,
    "pushing_no_clutter": make_pushing,
    "pushing_low_clutter": functools.partial(make_pushing, 3),
    "pushing_moderate_clutter_constrained": functools.partial(
        make_pushing, "constrained"),
    "walker_walk": functools.partial(make_walker, run=False),
    "walker_run": functools.partial(make_walker, run=True),
    "walker_uneven": functools.partial(make_walker, uneven=True),
    "box_sweep": make_box_sweep,
    "threeD_push": make_threed_push,
}


def task_names():
    return tuple(sorted(_REGISTRY))


# tasks of the JAX registry the port does not run yet, and why
_LATER = {
    "pushing_moderate_clutter": (
        "push_mcl's 7 obstacles: 45 contact pairs unrolled at compile time "
        "keep nvcc too long (ROADMAP: K2b's pairs at run time), and no "
        "backward-pass instance at nx 62 is built"),
}


def make_task(name: str, device=None):
    if name in _LATER:
        raise NotImplementedError(f"task {name!r} is not ported yet: "
                                  f"{_LATER[name]}")
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown task {name!r}; the port has {task_names()} (the other "
            "tasks wait in ROADMAP: moderate clutter, place and sweep_multiple "
            "among the modules to port, humanoid and soft bodies with the "
            "engine outside the lane scope)"
        )
    return _REGISTRY[name](device=device)
