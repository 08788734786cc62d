"""Straggler detection and mitigation hooks (host side).

Every worker reports its per-step wall time; a straggler is a worker whose
recent median exceeds the fleet median by ``z_thresh`` robust z-scores.
Mitigations are returned as recommendations; the launcher acts on them:

* ``"recompile_spare"``: swap in a hot spare and re-shard (the elastic
  path),
* ``"skip_collective_timeout"``: raise the collective timeout for transient
  network jitter,
* ``"checkpoint_now"``: a preemptive checkpoint when degradation is
  trending.

Baseline discipline: the first ``warmup`` records of every timer are
discarded (first-call set-up, not steady-state step time: folding them into
the baseline inflates it so far that real stragglers are never flagged).
Once ``baseline_min`` clean samples exist the baseline seeds from their
median and then tracks the recent median with a slow EMA
(``baseline_alpha``), so benign long-term drift is absorbed while a fast
sustained degradation still trips the ``trend_thresh`` check.

Plain Python, so it runs in the serving process next to the hot loop;
``serve/runtime.py`` feeds it per-shard search timings.  The same
arithmetic as the reference's ``ft/straggler.py``, number for number.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque


@dataclasses.dataclass
class StragglerConfig:
    window: int = 32           # ring buffer of recent step times
    z_thresh: float = 4.0      # robust z-score to flag
    trend_thresh: float = 1.5  # sustained slowdown factor → checkpoint advice
    warmup: int = 4            # leading records to discard (first-call set-up)
    baseline_min: int = 8      # clean samples before a baseline exists
    baseline_alpha: float = 0.01  # EMA rate of the slowly-updating baseline
    recent: int = 8            # trailing samples the trend/straggle checks use
    min_ratio: float = 1.25    # z-flag also needs this much absolute slowdown


class StepTimer:
    """Per-worker step-time ring buffer with robust outlier detection."""

    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.times: Deque[float] = deque(maxlen=cfg.window)
        self.baseline: float | None = None
        self._seen = 0  # total records, including discarded warmup

    def record(self, seconds: float) -> None:
        self._seen += 1
        if self._seen <= self.cfg.warmup:
            return  # set-up spike: never enters the window
        self.times.append(seconds)
        if self.baseline is None:
            if len(self.times) >= self.cfg.baseline_min:
                self.baseline = _median(list(self.times))
        else:
            med = _median(self._recent())
            self.baseline += self.cfg.baseline_alpha * (med - self.baseline)

    def _recent(self) -> list[float]:
        r = min(self.cfg.recent, len(self.times))
        return list(self.times)[-r:] if r else []

    def is_straggling(self) -> bool:
        if self.baseline is None or len(self.times) < self.cfg.baseline_min:
            return False
        recent = self._recent()
        med = _median(recent)
        mad = _median([abs(t - med) for t in recent]) + 1e-9
        z = (med - self.baseline) / (1.4826 * mad)
        # The MAD of a steady recent window is ~0, which makes the z-score
        # hypersensitive to any baseline lag (smooth drift would false-alarm);
        # require a material absolute slowdown as well.
        return z > self.cfg.z_thresh and med > self.cfg.min_ratio * self.baseline

    def recommendation(self) -> str | None:
        if not self.times or self.baseline is None:
            return None
        recent_mean = sum(self._recent()) / len(self._recent())
        if recent_mean > self.cfg.trend_thresh * self.baseline:
            return "checkpoint_now"
        if self.is_straggling():
            return "recompile_spare"
        return None


class FleetMonitor:
    """Aggregates per-worker timers (a single-process stand-in for a
    cross-host heartbeat service).  ``serve/runtime.py`` points one worker
    slot at every shard of a sharded index and feeds per-shard search
    timings through :meth:`record`."""

    def __init__(self, n_workers: int, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.timers = [StepTimer(cfg) for _ in range(n_workers)]

    def record(self, worker: int, seconds: float) -> None:
        self.timers[worker].record(seconds)

    def stragglers(self) -> list[int]:
        """Workers whose recent median is a fleet-level robust outlier."""
        meds = [
            _median(t._recent()) if t.times else math.inf for t in self.timers
        ]
        fleet_med = _median([m for m in meds if math.isfinite(m)] or [0.0])
        mad = _median([abs(m - fleet_med) for m in meds if math.isfinite(m)] or [0.0]) + 1e-9
        out = []
        for i, m in enumerate(meds):
            if (
                math.isfinite(m)
                and (m - fleet_med) / (1.4826 * mad) > self.cfg.z_thresh
                and m > self.cfg.min_ratio * fleet_med
            ):
                out.append(i)
        return out

    def recommendations(self) -> dict[int, str]:
        """Per-worker mitigation advice (workers with none are omitted)."""
        out = {}
        for i, t in enumerate(self.timers):
            rec = t.recommendation()
            if rec is not None:
                out[i] = rec
        return out


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
