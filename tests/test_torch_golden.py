"""The port's `optimise` reproduces the JAX package's golden acrobot solve
(tests/golden/acrobot_si5_h200.npz, set up as tests/test_golden.py does:
SI_5, H = 200, 6 iterations, FD derivatives) on the plain CPU path.

The bars are those of FD noise, not the golden test's own 1e-6.  That test
pins one floating-point path: the JAX package itself, run on the same setup
with exact forward-mode Jacobians (`deriv_mode="ad_time"`) instead of FD,
lands 3.8e-5 (ctrl), 8.9e-6 (qpos) and 7.2e-5 (final cost) from the golden,
because the solve amplifies the ~1e-9 FD noise of the Jacobians.  The port's
step rounds a few operations differently from XLA's (1 ulp in qM and the
bias force), so its FD columns carry different noise of the same size: the
plain path lands 3.2e-5, 8.1e-6 and 6.0e-5 away, the CUDA kernel path on an
H100 8.1e-5, 2.0e-5 and 1.5e-4 (chip_smoke.py).  The bars below are five
times the JAX package's own spread.  No JAX runs here.
"""

import os

import numpy as np
import torch

from trajoptkp_tpu_torch.solver.ilqr import ILQRConfig, optimise
from trajoptkp_tpu_torch.tasks.toys import make_acrobot

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "acrobot_si5_h200.npz")


CTRL_ATOL, QPOS_ATOL, COST_ATOL = 2e-4, 5e-5, 4e-4


def golden_task(device):
    task = make_acrobot(device=device)
    f64 = dict(dtype=torch.float64, device=task.model.device)
    return task.replace(
        weights=torch.tensor([0.0, 0.0, 0.001, 0.001, 0.01], **f64),
        weights_terminal=torch.tensor([100.0, 100.0, 1.0, 1.0, 0.01], **f64),
        keypoint_cfg=task.keypoint_cfg.replace(name="set_interval", min_N=5),
    )


def test_acrobot_si5_golden_plain_path():
    z = np.load(GOLDEN)
    task = golden_task("cpu")
    H = 200
    traj, stats = optimise(task, task.qpos_start, task.qvel_start,
                           torch.zeros((H, 1), dtype=torch.float64),
                           ILQRConfig(max_iterations=6, min_iterations=6))
    np.testing.assert_allclose(traj.ctrl.numpy(), z["ctrl"], atol=CTRL_ATOL,
                               err_msg="control sequence drifted from golden")
    np.testing.assert_allclose(traj.qpos.numpy(), z["qpos"], atol=QPOS_ATOL)
    assert abs(stats.final_cost - float(z["final_cost"])) < COST_ATOL
    assert stats.num_iterations == 6
