"""(Copy of transfuser_tpu/harness/watchdog.py.)

Thread-timer watchdog (reference srunner watchdog.py:21-: raises
KeyboardInterrupt in the main thread on timeout)."""

from __future__ import annotations

import _thread
import threading
from typing import Optional


class Watchdog:
    def __init__(self, timeout: float = 1.0):
        self._timeout = timeout + 1.0
        self._failed = False
        self._timer: Optional[threading.Timer] = None
        self._stopped = True

    def start(self) -> None:
        self._stopped = False
        self._arm()

    def _arm(self) -> None:
        if self._timer:
            self._timer.cancel()
        self._timer = threading.Timer(self._timeout, self._on_timeout)
        self._timer.daemon = True
        self._timer.start()

    def update(self) -> None:
        if not self._stopped:
            self._arm()

    def stop(self) -> None:
        self._stopped = True
        if self._timer:
            self._timer.cancel()

    def _on_timeout(self) -> None:
        if self._stopped:
            return
        self._failed = True
        _thread.interrupt_main()

    def get_status(self) -> bool:
        """True while healthy."""
        return not self._failed
