"""Structured metrics as JSONL (counterpart of
``celeste_tpu/utils/metrics.py``): one object per event, host side only."""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


class MetricsLogger:
    """Append-only JSONL metrics stream (file, or stderr without a path)."""

    def __init__(self, path: str | None = None):
        self._fh = open(path, "a") if path else sys.stderr
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
