"""Process-wide logger (reference: src/utils/zklog.{hpp,cpp}).

The port's own copy of ``xlayer_prover_tpu/utils/log.py``.  Thread-safe
info/warning/error with optional JSON lines, pid/thread tags and
per-request context tags (the reference's LogTag mechanism).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time


class ZkLog:
    def __init__(self):
        self._lock = threading.Lock()
        self.json_mode = False
        self.prefix = ""
        self._tags = threading.local()

    def set_tags(self, **tags):
        self._tags.tags = tags

    def clear_tags(self):
        self._tags.tags = {}

    def _emit(self, level: str, msg: str):
        tags = getattr(self._tags, "tags", {}) or {}
        with self._lock:
            if self.json_mode:
                rec = {"ts": time.time(), "level": level, "pid": os.getpid(),
                       "msg": msg, **tags}
                sys.stderr.write(json.dumps(rec) + "\n")
            else:
                tagstr = " ".join(f"{k}={v}" for k, v in tags.items())
                ts = time.strftime("%Y%m%d_%H%M%S")
                sys.stderr.write(
                    f"{ts} {os.getpid()} {level} {self.prefix}{msg}"
                    f"{(' ' + tagstr) if tagstr else ''}\n")
            sys.stderr.flush()

    def info(self, msg: str):
        self._emit("I", msg)

    def warning(self, msg: str):
        self._emit("W", msg)

    def error(self, msg: str):
        self._emit("E", msg)


zklog = ZkLog()
