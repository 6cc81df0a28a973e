"""Progress reporting with an adaptive ETA.

Replaces the reference's progressbar + ``AdaptiveETA`` widget
(``adaptive_progress.py:8-50``, ``multi_nested_integrator.py:86-146``): a
blended global/windowed rate estimate and a single status line with iteration
count, draw count, surviving datasets and the first dataset's running logZ —
without external dependencies.

The port's own copy of ``massivedatans_tpu/utils/progress.py``:
same names and output.
"""

from __future__ import annotations

import sys
import time
from collections import deque


class AdaptiveETA:
    """Blend of global-average and recent-window rate (adaptive_progress.py:8).

    The window estimate dominates once enough samples exist, which tracks the
    slowdown near the end of an NS run better than a global average.
    """

    def __init__(self, window: int = 10):
        self.start = time.time()
        self.samples = deque(maxlen=window)

    def eta(self, done: int, total: int) -> float:
        now = time.time()
        self.samples.append((done, now))
        if done <= 0 or total <= done:
            return 0.0
        global_rate = done / max(now - self.start, 1e-9)
        if len(self.samples) >= 2:
            d0, t0 = self.samples[0]
            dn, tn = self.samples[-1]
            if dn > d0 and tn > t0:
                window_rate = (dn - d0) / (tn - t0)
                # weight toward the window as it fills
                frac = len(self.samples) / self.samples.maxlen
                rate = (1 - frac) * global_rate + frac * window_rate
            else:
                rate = global_rate
        else:
            rate = global_rate
        return (total - done) / max(rate, 1e-12)


class ProgressReporter:
    def __init__(self, enabled: bool = True, ndata: int = 0):
        self.enabled = enabled and sys.stderr.isatty()
        self.log_enabled = enabled
        self.ndata = ndata
        self.eta = AdaptiveETA()
        self._last_print = 0.0

    def update(self, it: int, ndraws: int, running: int, logZ0: float,
               shelves: str = ""):
        if not self.log_enabled:
            return
        now = time.time()
        if now - self._last_print < 0.5 and running > 0:
            return
        self._last_print = now
        elapsed = now - self.eta.start
        rate = it / max(elapsed, 1e-9)
        msg = (
            f"| it {it} | draws {ndraws} | {running}/{self.ndata} running "
            f"| lnZ[0] = {logZ0:.2f} | {rate:.1f} it/s |"
        )
        if shelves:
            msg += f" [{shelves}]"
        end = "\r" if self.enabled and running > 0 else "\n"
        print(msg, end=end, file=sys.stderr, flush=True)

    def finish(self, niter: int, ndraws: int, duration: float):
        if not self.log_enabled:
            return
        print(
            f"done: {niter} iterations, {ndraws} draws in {duration:.1f}s "
            f"({ndraws / max(duration, 1e-9):.0f} evals/s)",
            file=sys.stderr,
        )


_SPARK_LEVELS = " ▁▂▃▄▅▆▇█"


def shelf_sparkline(counts, capacity: int, width: int = 64) -> str:
    """Unicode shelf-occupancy sparkline (reference ``shelf_status``,
    multi_nested_sampler.py:26-36): one glyph per dataset, block-averaged
    down to ``width`` characters for large D."""
    import numpy as np

    counts = np.asarray(counts, float)
    if counts.size == 0 or capacity <= 0:
        return ""
    if counts.size > width:
        pad = (-counts.size) % width
        counts = np.pad(counts, (0, pad), constant_values=np.nan)
        with np.errstate(invalid="ignore"):
            counts = np.nanmean(counts.reshape(width, -1), axis=1)
        counts = np.nan_to_num(counts)  # blocks that were entirely padding
    frac = np.clip(counts / capacity, 0.0, 1.0)
    idx = np.round(frac * (len(_SPARK_LEVELS) - 1)).astype(int)
    return "".join(_SPARK_LEVELS[i] for i in idx)
