"""Structured metrics: the port's copy of `rambl_tpu/utils/metrics.py`.

Every stage emits a structured record: JSONL to a file (machine-readable)
and a human console line on stderr.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, quiet: bool = False):
        self.path = path
        self.quiet = quiet
        self._fh = open(path, "a") if path else None
        self.t0 = time.time()

    def log(self, stage: str, **fields):
        rec = {"t": round(time.time() - self.t0, 3), "stage": stage, **fields}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if not self.quiet:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{rec['t']:9.2f}s] {stage}: {kv}", file=sys.stderr, flush=True)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
