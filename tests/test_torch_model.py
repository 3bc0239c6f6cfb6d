"""The port's Model carries the JAX Model across as data.

`write_model_npz` is the one writer of `trajoptkp_tpu_torch/models/*.npz`:
it dumps a JAX `Model` (from `load_mjcf` on the repo's XMLs, and for
`push_ncl`, `push_lcl` and `push_ccl` from the pushing scenes
`tasks/pushing.py:build_push_scene_xml` assembles around panda.xml (no
clutter, three obstacles, the constrained corridor with the goal at (0.4,
0.2)), for `box_sweep` and `threeD_push` from the
scenes of `tasks/manipulation.py:make_box_sweep` and `make_threed_push`)
field by field.
Regenerate with

    JAX_PLATFORMS=cpu python -c "from tests.test_torch_model import \\
        write_all_models; write_all_models()"

The tests hold the checked-in files and `model_from_numpy` to `load_mjcf`
exactly (tolerance 0: the npz holds the same float64 values).
"""

import os

import jax
import numpy as np
import pytest
import torch

from trajoptkp_tpu.dynamics.mjcf import load_mjcf, load_mjcf_string
from trajoptkp_tpu.tasks.pushing import build_push_scene_xml
from trajoptkp_tpu_torch.dynamics import model as pm

jax.config.update("jax_enable_x64", True)

XML_DIR = os.path.join(os.path.dirname(__file__), "..", "trajoptkp_tpu",
                       "models")
PORTED = ("acrobot", "pentabot", "panda", "push_ncl", "walker", "box_sweep",
          "threeD_push", "push_lcl", "push_ccl")


def jax_model(name: str):
    """The JAX Model each checked-in npz is written from."""
    if name == "push_ncl":
        return load_mjcf_string(build_push_scene_xml(0))
    if name == "push_lcl":
        return load_mjcf_string(build_push_scene_xml(3))
    if name == "push_ccl":
        return load_mjcf_string(build_push_scene_xml("constrained",
                                                     goal_start=(0.4, 0.2)))
    if name in ("box_sweep", "threeD_push"):
        from trajoptkp_tpu.tasks.manipulation import (make_box_sweep,
                                                      make_threed_push)
        make = make_box_sweep if name == "box_sweep" else make_threed_push
        return make().model
    return load_mjcf(os.path.join(XML_DIR, f"{name}.xml"))


def _npz_fields(jm) -> dict:
    out = {}
    for f in pm.INT_FIELDS:
        out[f] = np.asarray(getattr(jm, f), np.int64)
    for f in pm.INT_TUPLE_FIELDS:
        out[f] = np.asarray(getattr(jm, f), np.int64).reshape(-1)
    for f in pm.BOOL_TUPLE_FIELDS:
        out[f] = np.asarray(getattr(jm, f), bool).reshape(-1)
    for f in pm.NAME_FIELDS:
        out[f] = np.asarray(getattr(jm, f), dtype=np.str_).reshape(-1)
    out["contact_pairs"] = np.asarray(jm.contact_pairs, np.int64).reshape(-1, 2)
    out["integrator"] = np.asarray(jm.integrator, dtype=np.str_)
    out["source_xml"] = np.asarray(jm.source_xml or "", dtype=np.str_)
    for f in pm.ARRAY_FIELDS:
        out[f] = np.asarray(getattr(jm, f), np.float64)
    return out


def write_model_npz(jm, path: str) -> None:
    np.savez(path, **_npz_fields(jm))


def write_all_models() -> None:
    for name in PORTED:
        jm = jax_model(name)
        write_model_npz(jm, os.path.join(pm.MODELS_DIR, f"{name}.npz"))


def _assert_model_equal(port, jm):
    for f in (pm.INT_FIELDS + pm.INT_TUPLE_FIELDS + pm.BOOL_TUPLE_FIELDS
              + pm.NAME_FIELDS + pm.STR_FIELDS):
        assert getattr(port, f) == getattr(jm, f), f
    assert port.contact_pairs == tuple(tuple(p) for p in jm.contact_pairs)
    for f in pm.ARRAY_FIELDS:
        got = getattr(port, f)
        assert got.dtype == torch.float64, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jm, f)),
                                      err_msg=f)


@pytest.mark.parametrize("name", PORTED)
def test_checked_in_npz_matches_load_mjcf(name):
    jm = jax_model(name)
    port = pm.load_model(name, device="cpu")
    _assert_model_equal(port, jm)


@pytest.mark.parametrize("name", PORTED)
def test_model_from_numpy_matches_load_mjcf(name, tmp_path):
    jm = jax_model(name)
    path = tmp_path / f"{name}.npz"
    write_model_npz(jm, str(path))
    with np.load(path) as z:
        port = pm.model_from_numpy(z, device="cpu")
    _assert_model_equal(port, jm)
    # the writer is deterministic: the checked-in file holds the same arrays
    with np.load(path) as fresh, \
            np.load(os.path.join(pm.MODELS_DIR, f"{name}.npz")) as kept:
        assert sorted(fresh.files) == sorted(kept.files)
        for f in fresh.files:
            np.testing.assert_array_equal(fresh[f], kept[f], err_msg=f)


@pytest.mark.parametrize("task_name,tag,nlim",
                         [("acrobot", "acrobot", 0), ("pentabot", "pentabot", 0),
                          ("reaching", "reaching", 7),
                          ("pushing_no_clutter", "push_ncl", 7),
                          ("walker_run", "walker", 6),
                          ("box_sweep", "box_sweep", 7),
                          ("threeD_push", "threeD_push", 7)])
def test_task_maps_to_its_kernel_instance(task_name, tag, nlim):
    """Each ported task finds its instance in kernels/csrc/instances.cuh,
    and the packed model buffer has the layout step.cuh reads: 18 per body,
    11 per dof (damping, armature, then its joint's position, axis, qpos0,
    stiffness and spring reference, zero for a free joint's dofs), 5 per
    actuator, the limit constants, the contact pairs (geom poses and sizes,
    then the pair's constants), gravity, timestep."""
    from trajoptkp_tpu_torch.config.loader import make_task
    from trajoptkp_tpu_torch.dynamics.contact import (CONTACT_FIELDS,
                                                      LIMIT_FIELDS,
                                                      contact_constants,
                                                      limit_constants)
    from trajoptkp_tpu_torch.kernels import ops

    task = make_task(task_name, device="cpu")
    m = task.model
    ka = ops.kernel_args(task, torch.device("cpu"))
    assert ka.tag == tag
    # the entry ops.instance_line writes is the one instances.cuh holds
    text = (ops.build.CSRC / "instances.cuh").read_text()
    flat = "".join(text.replace("\\\n", "").split())
    assert "".join(ops.instance_line(task, tag).split()) in flat
    # packed once per task: the launch path must not pack again
    assert ops.kernel_args(task, torch.device("cpu")) is ka
    nb = m.nbody - 1
    lim = nlim * len(LIMIT_FIELDS)
    cc = contact_constants(m)
    pair = 20 + len(CONTACT_FIELDS)
    dofb = 18 * nb
    assert ka.model_buf.numel() == (dofb + 11 * m.nv + 5 * m.nu + lim
                                    + pair * len(cc.pairs) + 4)
    # an FK residual's constants (the ee site on its body) close the task
    # buffer
    res = 3 if task.residual_kind[0] in ops.FK_KINDS else 0
    assert ka.task_buf.numel() == 2 * task.nres + 2 * m.nu + res
    if res:
        np.testing.assert_array_equal(
            ka.task_buf[-3:].numpy(),
            m.site_pos[m.site_names.index("ee")].numpy())
    off = dofb + 11 * m.nv + 5 * m.nu
    np.testing.assert_array_equal(
        ka.model_buf[off:off + lim].numpy(),
        limit_constants(m).table.reshape(-1).numpy())
    for p in range(len(cc.pairs)):
        rec = ka.model_buf[off + lim + pair * p:off + lim + pair * (p + 1)]
        np.testing.assert_array_equal(rec[20:].numpy(), cc.table[p].numpy())
        np.testing.assert_array_equal(rec[7:10].numpy(),
                                      m.geom_size[cc.pairs[p].g1].numpy())
    np.testing.assert_array_equal(ka.model_buf[-4:-1].numpy(),
                                  m.gravity.numpy())
    dofs = ka.model_buf[dofb:dofb + 11 * m.nv].reshape(m.nv, 11)
    np.testing.assert_array_equal(
        dofs[:, :2].numpy(),
        torch.stack([m.dof_damping, m.dof_armature], 1).numpy())
    for b in range(1, m.nbody):
        rec = ka.model_buf[18 * (b - 1):18 * b]
        assert float(rec[14]) == float(m.body_mass[b])
    # a free joint's dofs pack zero joint fields; a hinge's or slide's its
    # own, on every joint of a body that carries several
    for j in range(m.njnt):
        d = m.jnt_dofadr[j]
        if m.jnt_type[j] == pm.FREE:
            assert float(dofs[d:d + 6, 2:].abs().max()) == 0.0
        else:
            np.testing.assert_array_equal(dofs[d, 5:8].numpy(),
                                          m.jnt_axis[j].numpy())
    # the limited mask is part of the key: without limits, no instance
    if nlim:
        free = task.replace(model=m.replace(jnt_limited=(False,) * m.njnt))
        with pytest.raises(NotImplementedError, match="no kernel instance"):
            ops.kernel_args(free, torch.device("cpu"))


def test_load_model_unknown_name_raises():
    with pytest.raises(FileNotFoundError, match="acrobot"):
        pm.load_model("humanoid", device="cpu")


def test_backward_instance_and_schedule_are_cached(monkeypatch):
    """ops.backward's instance lookup reads instances.cuh once and its λ
    schedule is built once per (nx, nu, schedule, device): a second call
    parses nothing and hands back the same tensor."""
    import pathlib

    from trajoptkp_tpu_torch.kernels import ops
    from trajoptkp_tpu_torch.solver.ilqr import ILQRConfig

    reads = []
    real = pathlib.Path.read_text

    def counting(self, *a, **k):
        reads.append(self.name)
        return real(self, *a, **k)

    monkeypatch.setattr(pathlib.Path, "read_text", counting)
    ops.backward_instances.cache_clear()
    monkeypatch.setattr(ops, "_BP_ARGS", {})
    cfg, cpu = ILQRConfig(), torch.device("cpu")
    first = ops.backward_args(20, 7, cfg, cpu)
    assert first[0] == "trajopt_backward_nx20_nu7"
    assert reads == ["instances.cuh"]
    assert ops.backward_args(20, 7, cfg, cpu) is first
    assert ops.backward_args(14, 7, cfg, cpu)[1] is not first[1]
    assert reads == ["instances.cuh"]
    with pytest.raises(NotImplementedError, match="nx=12, nu=7"):
        ops.backward_args(12, 7, cfg, cpu)
