"""PyTorch + CUDA port of the TPU-native SLAM engine, for one NVIDIA H100.

A second package beside :mod:`orb_slam3_noted_tpu`, which stays the
reference: every module here mirrors the JAX module of the same name and is
held to it by the parity tests in ``tests/test_torch_*.py``.  Ported so far
(``pipeline/system.py``, ``pipeline/inertial_system.py``): monocular,
stereo, fisheye stereo and RGB-D SLAM, with and without an IMU, frame by
frame and in batches, with the keyframe mapper, relocalisation (``place/``,
``optim/pnp.py``), loop closing and localisation mode.  The four kernels that
the JAX package wrote in Pallas (FAST score, 7-tap blur, rBRIEF sampling,
stereo SAD) are CUDA C++ for ``sm_90a`` in ``csrc/``, built with ``nvcc`` on
first use and bound with ``ctypes`` (``ops/cuda_kernels.py``).

Plain functions on tensors; every entry point that allocates state takes an
explicit ``device``.  This package never imports ``jax``.
"""

import torch as _torch

# Counterpart of ``jax_default_matmul_precision="highest"`` in the JAX
# package: SLAM geometry (pose chains, normal equations) needs full float32
# products, and TF32 keeps only about three decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
