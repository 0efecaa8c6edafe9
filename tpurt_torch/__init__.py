"""tpurt_torch — the PyTorch/CUDA port of tpurt for NVIDIA Hopper.

The JAX package ``tpurt`` stays the reference; this package mirrors its
module layout and names (``tpurt_torch.kernels.tilewave`` is the
counterpart of ``tpurt.kernels.tilewave``) and never imports it or jax.
Host code (procedural scenes, the cluster build) is copied, device code is
plain functions on torch tensors, and every Pallas kernel on the ported
path is a hand-written CUDA C++ kernel under ``csrc/`` with a plain
PyTorch version beside it.
"""

__version__ = "0.1.0"

# Geometry correctness requires full-f32 matmuls and convolutions (the
# reference pins the TPU the same way, tpurt/__init__.py): TF32 keeps ~3
# decimal digits, which corrupts ray/instance transforms in large scenes.
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
del _torch
