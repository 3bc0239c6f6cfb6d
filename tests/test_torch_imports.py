"""The port stands alone: importing every module of `trajoptkp_tpu_torch`
and chip_smoke.py's imports loads neither JAX nor the JAX package, and the
entry points refuse to run on the CPU unless asked to."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The port's CPU tests step small tensors in several pytest workers side by
# side, where torch's default of one intra-op thread per core oversubscribes
# the cores: a box CLI solve at --horizon 10 took 37 s with the default and
# 11 s with one thread while other processes ran.  Every worker imports this
# module when it collects the tests, so this holds for every test it runs.
torch.set_num_threads(1)

_PROBE = r"""
import importlib, json, pkgutil, sys
import trajoptkp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    trajoptkp_tpu_torch.__path__, "trajoptkp_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "trajoptkp_tpu" or m.startswith("trajoptkp_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("trajoptkp_tpu_torch.kernels.ops",
                "trajoptkp_tpu_torch.solver.lanes",
                "trajoptkp_tpu_torch.dynamics.contact",
                "trajoptkp_tpu_torch.dynamics.constraint",
                "trajoptkp_tpu_torch.tasks.reaching",
                "trajoptkp_tpu_torch.dynamics.collision",
                "trajoptkp_tpu_torch.tasks.pushing",
                "trajoptkp_tpu_torch.tasks.locomotion",
                "trajoptkp_tpu_torch.tasks.manipulation",
                "trajoptkp_tpu_torch.mpc.sync",
                "trajoptkp_tpu_torch.mpc.async_mpc",
                "trajoptkp_tpu_torch.mpc.native_executor",
                "trajoptkp_tpu_torch.bench.campaigns",
                "trajoptkp_tpu_torch.derivs.ad",
                "trajoptkp_tpu_torch.sass_counts",
                "trajoptkp_tpu_torch.app"):
        assert mod in res["modules"]


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    from trajoptkp_tpu_torch import app
    from trajoptkp_tpu_torch.dynamics.model import load_model
    from trajoptkp_tpu_torch.tasks.manipulation import (make_box_sweep,
                                                        make_threed_push)
    from trajoptkp_tpu_torch.tasks.toys import make_acrobot

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_acrobot()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model("acrobot")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app.main(["--task", "acrobot", "--keypoint", "SI_5"])
    for make in (make_box_sweep, make_threed_push):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app.main(["--task", "box_sweep", "--runMode", "Optimise_once"])
    assert make_acrobot(device="cpu").model.device.type == "cpu"


def test_cli_refuses_what_is_not_ported(capsys):
    from trajoptkp_tpu_torch import app

    with pytest.raises(ValueError, match="want SI_n, AJ_a_b"):
        app.main(["--device", "cpu", "--keypoint", "XY_1_100"])
    with pytest.raises(ValueError, match="want SI_n, AJ_a_b"):
        app.main(["--device", "cpu", "--keypoint", "VC_1"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        app.main(["--device", "cpu", "--runMode", "Init_controls"])
    app.main(["--device", "cpu", "--keypoint", "SI_2", "--horizon", "12",
              "--maxIter", "2", "--minIter", "1"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(last)
    assert out["task"] == "acrobot" and out["horizon"] == 12
    assert out["final_cost"] <= out["initial_cost"]


def test_cli_solves_reaching_and_names_the_ported_tasks(capsys):
    from trajoptkp_tpu_torch import app
    from trajoptkp_tpu_torch.config.loader import make_task, task_names

    assert task_names() == ("acrobot", "box_sweep", "pentabot",
                            "pushing_low_clutter",
                            "pushing_moderate_clutter_constrained",
                            "pushing_no_clutter", "reaching", "threeD_push",
                            "walker_run", "walker_uneven", "walker_walk")
    with pytest.raises(KeyError, match="reaching"):
        make_task("push_ncl", device="cpu")
    # push_mcl's 45 pairs and nx 62 wait for a later slice
    with pytest.raises(NotImplementedError, match="45 contact pairs"):
        make_task("pushing_moderate_clutter", device="cpu")
    # reaching's own method, velocity_change
    app.main(["--device", "cpu", "--task", "reaching", "--horizon", "6",
              "--maxIter", "1", "--minIter", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["keypoint_method"] == "velocity_change"
    assert 0.0 < out["mean_pct_derivs"] <= 100.0
    app.main(["--device", "cpu", "--task", "reaching", "--keypoint", "SI_3",
              "--horizon", "8", "--maxIter", "2", "--minIter", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["task"] == "reaching" and out["horizon"] == 8
    assert out["iterations"] == 2
    assert out["final_cost"] <= out["initial_cost"]
    assert "reaching" in app.build_parser().format_help()
