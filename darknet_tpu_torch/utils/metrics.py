"""Structured training metrics — JSONL per step + the human-readable line;
the port's copy of `darknet_tpu/utils/metrics.py`.

The reference logs printf text only (SURVEY.md §5 'observability'); this
adds a machine-readable stream: one JSON object per iteration with loss
components, lr, imgs/sec, and mAP events, suitable for plotting or
monitoring, while keeping the classic
``[iter] loss, avg loss, lr, images, hours left`` line.
"""

from __future__ import annotations

import json
import time


class MetricsLogger:
    def __init__(self, path: str | None = None, log=print):
        self.path = path
        self.log = log
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def step(self, iteration: int, **fields) -> None:
        rec = {"event": "step", "iter": iteration,
               "t": round(time.time() - self._t0, 3), **fields}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def map_event(self, iteration: int, map_value: float) -> None:
        rec = {"event": "map", "iter": iteration, "map": map_value,
               "t": round(time.time() - self._t0, 3)}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
