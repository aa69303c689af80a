"""Structured metrics: a JSONL event stream, optionally echoed to stderr.

The counterpart of the JAX package's ``utils/metrics.py``: each event is
one JSON object per line with its wall-clock offset ``t`` (seconds since
the logger was made), so runs of both packages compare line by line.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self._fh: Optional[IO] = None
        self._echo = echo
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, event: str, **fields):
        rec = {"event": event, "t": round(time.time() - self._t0, 3), **fields}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        if self._echo:
            print(json.dumps(rec), file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
