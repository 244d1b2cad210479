"""The benchmark of ``celeste_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA cards: ``python -m skybench --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` (``run.py``).  It measures the port only and imports
neither JAX nor the JAX package."""
