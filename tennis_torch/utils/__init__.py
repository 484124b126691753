"""Runtime utilities: checkpoint reading, experiment dirs and logging, and
the ``Progress`` reporter (counterpart of ``tennis_tpu/utils/__init__.py``,
on stdlib ``logging``)."""
from __future__ import annotations

import logging
import time

log = logging.getLogger(__name__)


class Progress:
    """Rate/ETA reporter for long offline jobs (dataset scans, feature
    dumps): one log line at most every ``interval`` seconds, no tty redraw,
    plus a final summary.

    >>> p = Progress(total_frames, "scanning train frames", unit="frames")
    >>> p.update(n_done); ...; p.close()

    or wrap an iterable: ``for x in Progress.wrap(items, "scanning"): ...``
    """

    def __init__(self, total: int | None, desc: str, unit: str = "it",
                 interval: float = 10.0):
        self.total = total
        self.desc = desc
        self.unit = unit
        self.interval = interval
        self.n = 0
        self._start = self._last = time.monotonic()

    def _line(self) -> str:
        dt = max(time.monotonic() - self._start, 1e-9)
        rate = self.n / dt
        if self.total:
            n = min(self.n, self.total)  # chunked updates may round up
            eta = (self.total - n) / max(rate, 1e-9)
            return (f"{self.desc}: {n}/{self.total} "
                    f"({100.0 * n / self.total:.0f}%) "
                    f"{rate:.1f} {self.unit}/s, ETA {eta:.0f}s")
        return f"{self.desc}: {self.n} {rate:.1f} {self.unit}/s"

    def update(self, k: int = 1) -> None:
        self.n += k
        now = time.monotonic()
        if now - self._last >= self.interval:
            self._last = now
            log.info("%s", self._line())

    def close(self) -> None:
        log.info("%s [done in %.1fs]", self._line(),
                 time.monotonic() - self._start)

    @classmethod
    def wrap(cls, iterable, desc: str, total: int | None = None,
             unit: str = "it", interval: float = 10.0):
        if total is None:
            try:
                total = len(iterable)
            except TypeError:
                total = None
        p = cls(total, desc, unit=unit, interval=interval)
        try:
            for item in iterable:
                yield item
                p.update()
        finally:
            p.close()
