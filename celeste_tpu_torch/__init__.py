"""celeste_tpu_torch — the PyTorch + CUDA port of ``celeste_tpu``.

The package mirrors the JAX package's module layout and names, so each
module's counterpart is found at the same path under ``celeste_tpu/``.  It
imports ``torch`` and NumPy only; the pure-NumPy pieces of the JAX package
(profile tables, the oracle forward model) are copied in.

Plain tensor code is PyTorch.  The one hot-path kernel, the fused stamp
render + Poisson log-likelihood and its backward, is CUDA C++ for Hopper
(``csrc/mog_field.cu``), built with ``nvcc`` at first use and bound with
``ctypes`` (``kernels/_build.py``).  A CUDA tensor always goes through the
kernel; a CPU tensor takes the kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

from celeste_tpu_torch.mog import MoG2D  # noqa: F401
