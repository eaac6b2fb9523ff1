"""moldiff_tpu_torch: the PyTorch / CUDA port of moldiff_tpu for NVIDIA Hopper.

Same models, parameter layout and checkpoints as ``moldiff_tpu`` (the JAX
reference package), with the three forward pair kernels of the denoiser
written by hand in CUDA C++ (``csrc/``). Imports only torch and numpy; no
subpackage is imported eagerly, so ``import moldiff_tpu_torch`` is cheap.
"""

__version__ = "0.1.0"
