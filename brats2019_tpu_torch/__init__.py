"""brats2019_tpu_torch — the PyTorch + CUDA port of ``brats2019_tpu``.

The JAX package beside it stays the reference. This package imports torch
and nothing of jax or of the reference package; its host I/O
(``utils.nifti``, ``data.case``, ``data.constants``, ``data.synthetic``,
``infer.postprocess``) is a copy of the reference's NumPy code, pinned to it
by the tests. Public tensors keep the reference's NDHWC layout.

The four U-Net ops (3^3 conv, fused InstanceNorm+activation, 2x average-pool
down, 2x trilinear up) run on a CUDA tensor through hand-written Hopper
kernels (``ops/``, ``csrc/``) and on a CPU tensor through their plain torch
versions.
"""

__version__ = "0.1.0"
