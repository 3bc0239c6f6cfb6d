"""Task registry (counterpart of `trajoptkp_tpu/config/loader.py`).

Only the ported tasks.  No YAML/CSV config: the machine with the card has no
`yaml`, and the config layer is ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import functools

from ..tasks.locomotion import make_walker
from ..tasks.pushing import make_pushing
from ..tasks.reaching import make_reaching
from ..tasks.toys import make_acrobot, make_pentabot

_REGISTRY = {
    "acrobot": make_acrobot,
    "pentabot": make_pentabot,
    "reaching": make_reaching,
    "pushing_no_clutter": make_pushing,
    "walker_walk": functools.partial(make_walker, run=False),
    "walker_run": functools.partial(make_walker, run=True),
    "walker_uneven": functools.partial(make_walker, uneven=True),
}


def task_names():
    return tuple(sorted(_REGISTRY))


def make_task(name: str, device=None):
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown task {name!r}; the port has {task_names()} (the other "
            "tasks are ROADMAP Queue 1 items 7b and 11: clutter, boxes, "
            "manipulation, humanoid, soft bodies)"
        )
    return _REGISTRY[name](device=device)
