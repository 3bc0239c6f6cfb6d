"""trajoptkp_tpu_torch: keypoint-iLQR in PyTorch with hand-written CUDA kernels.

The PyTorch and CUDA port of `trajoptkp_tpu` for one NVIDIA H100.  Module
names mirror the JAX package so each file's counterpart is easy to find.
The package never imports JAX or `trajoptkp_tpu`.

Two numeric paths share every public function:

- the kernel path (`kernels/`), taken for tensors on a CUDA device: the
  rollout, line search, keypoint-slot FD Jacobians, cost expansion, Riccati
  backward pass, keypoint plans and MPC apply step run as CUDA C++ kernels
  for sm_90a, in float64;
- the plain path, a PyTorch twin of each kernel, taken for tensors on the
  CPU.  Tests run it against the JAX package, and `chip_smoke.py` holds each
  kernel against it on the card.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

import torch as _torch

# Physics needs full-precision float32 products wherever float32 appears
# (the counterpart of `trajoptkp_tpu/__init__.py:14-19`): TF32 keeps ~3
# decimal digits and breaks small Cholesky pipelines.  The default path is
# float64, which TF32 never touches; the pins keep any float32 use honest.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
