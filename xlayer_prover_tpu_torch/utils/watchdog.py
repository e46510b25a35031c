"""Watchdog timer (reference: src/utils/watchdog.hpp).

The port's own copy of ``xlayer_prover_tpu/utils/watchdog.py``.  Guards
long-running work: if not fed within the timeout, it invokes the callback
once (the aggregator client closes its stream with it).
"""

from __future__ import annotations

import threading
import time

from .log import zklog


class Watchdog:
    def __init__(self, timeout_s: float, on_timeout=None, name: str = "watchdog"):
        self.timeout_s = timeout_s
        self.name = name
        self.on_timeout = on_timeout
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = threading.Event()
        self._thread = None

    def start(self):
        self._last = time.monotonic()
        self._stop.clear()
        self._fired.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def feed(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(1.0)

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    def _run(self):
        while not self._stop.wait(min(self.timeout_s / 4, 1.0)):
            if time.monotonic() - self._last > self.timeout_s:
                self._fired.set()
                zklog.error(f"{self.name}: timeout after {self.timeout_s}s")
                if self.on_timeout:
                    self.on_timeout()
                return
