"""celeste_tpu_torch — the PyTorch + CUDA port of ``celeste_tpu``.

The package mirrors the JAX package's module layout and names, so each
module's counterpart is found at the same path under ``celeste_tpu/``.  It
imports ``torch`` and NumPy only; the pure-NumPy pieces of the JAX package
(profile tables, the oracle forward model) are copied in.

Plain tensor code is PyTorch.  The hot-path kernels are CUDA C++ for
Hopper, built with ``nvcc`` at first use and bound with ``ctypes``
(``kernels/_build.py``): the fused stamp render + Poisson log-likelihood
and its backward (``csrc/mog_field.cu``), and the block-sparse tiled field
of crowded fields: its log-likelihood forward, forward keeping lambda and
backward, and the sky-free lambda render of the source-sharded field with
its backward (``csrc/tiled_field.cu``).  A CUDA tensor always goes through
the kernels; a CPU tensor takes their plain PyTorch versions.  The sharded
paths run on ``torch.distributed`` (``parallel/``).  Quasar photo-z
(``quasar/``) and its tempered samplers are plain PyTorch: the JAX package
has no Pallas kernel there.
"""

__version__ = "0.1.0"

from celeste_tpu_torch.mog import MoG2D  # noqa: F401
