"""Structured metrics as JSONL (counterpart of
``celeste_tpu/utils/metrics.py``): one object per event, host side only.
PyTorch runs eagerly, so the JAX package's ``device_log`` (a callback out of
jitted code) is a plain call here: it writes the tensors' values through
the process's default logger (``get_logger``)."""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


class MetricsLogger:
    """Append-only JSONL metrics stream: a file, else ``stream``, else
    stderr."""

    def __init__(self, path: str | None = None, stream=None):
        self._fh = open(path, "a") if path else (stream or sys.stderr)
        self._owns = path is not None
        self._t0 = time.time()

    def log(self, event: str, **fields):
        rec = {"event": event, "t": round(time.time() - self._t0, 3)}
        for k, v in fields.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            if isinstance(v, np.ndarray):
                v = v.item() if v.ndim == 0 else np.round(v, 6).tolist()
            rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        if self._owns:
            self._fh.close()


_DEFAULT_LOGGER: MetricsLogger | None = None


def get_logger() -> MetricsLogger:
    """The process's default logger (JSONL to stderr), made at first use."""
    global _DEFAULT_LOGGER
    if _DEFAULT_LOGGER is None:
        _DEFAULT_LOGGER = MetricsLogger()
    return _DEFAULT_LOGGER


def device_log(event: str, **fields):
    """Emit a metrics record of tensor fields through the default logger;
    each tensor is read to the host, so call it sparingly (per adaptation
    window, not per step)."""
    get_logger().log(event, **fields)
