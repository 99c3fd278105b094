"""Plain per-engine counters: the subset of the ``/stf/serving/decode_*``,
``prefix_cache_*`` and ``spec_*`` metrics of ``simple_tensorflow_tpu/
serving/generative.py`` (:81-138) that the engine's paths update (the
prefill seconds of slot and paged admissions alike), plus
``WindowedRate`` from
``simple_tensorflow_tpu/platform/monitoring.py``. No registry and no
telemetry server: an engine owns one :class:`EngineMetrics` and
``snapshot()`` reads it."""

from __future__ import annotations

import statistics
import threading
import time
from collections import deque
from typing import Dict, Optional

# recent per-step samples kept for percentiles
_SAMPLES = 4096


class WindowedRate:
    """Events per second over the trailing ``window_s`` seconds
    (per-second buckets). Thread-safe."""

    def __init__(self, window_s: float = 10.0):
        self._window_s = max(1.0, float(window_s))
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}

    def add(self, n: int = 1, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        sec = int(now)
        with self._lock:
            self._buckets[sec] = self._buckets.get(sec, 0) + n
            horizon = int(now - self._window_s) - 1
            if len(self._buckets) > self._window_s + 2:
                for s in [s for s in self._buckets if s <= horizon]:
                    del self._buckets[s]

    def rate(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        lo = now - self._window_s
        with self._lock:
            total = sum(c for s, c in self._buckets.items() if s + 1 > lo)
        return total / self._window_s


class EngineMetrics:
    """Counters one engine updates (the engine thread, and submitting
    threads for rejections)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.tokens = 0
        self.steps = 0
        self.step_seconds = deque(maxlen=_SAMPLES)
        self.prefill_seconds = deque(maxlen=_SAMPLES)
        self.fill = deque(maxlen=_SAMPLES)
        self.per_token_seconds = deque(maxlen=_SAMPLES)
        self.sequences: Dict[str, int] = {}
        self.prefix_hits = 0
        self.prefix_evictions = 0
        self.prefix_shared_pages = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.slots_active = 0
        self.queue_depth = 0
        self.queue_stall_us = {"produce": 0, "consume": 0}
        self.rate = WindowedRate(10.0)

    def sequence(self, outcome: str) -> None:
        with self._lock:
            self.sequences[outcome] = self.sequences.get(outcome, 0) + 1

    def queue_stall(self, kind: str, seconds: float) -> None:
        us = int(seconds * 1e6)
        if us > 0:
            with self._lock:
                self.queue_stall_us[kind] += us

    def step(self, seconds: float, live: int, bucket: int,
             tokens: Optional[int] = None) -> None:
        """One engine step over ``live`` sequences at ``bucket``; it
        emitted ``tokens`` (one a sequence unless given)."""
        tokens = live if tokens is None else tokens
        with self._lock:
            self.steps += 1
            self.tokens += tokens
            self.step_seconds.append(seconds)
            self.fill.append(live / max(bucket, 1))
        self.rate.add(tokens)

    def speculative(self, proposed: int, accepted: int) -> None:
        """Draft proposals verified in one step, and how many the target
        accepted (the ``spec_*`` counters)."""
        with self._lock:
            self.spec_proposed += proposed
            self.spec_accepted += accepted

    def snapshot(self) -> dict:
        with self._lock:
            steps = list(self.step_seconds)
            per_token = list(self.per_token_seconds)
            return {
                "tokens": self.tokens,
                "steps": self.steps,
                "step_seconds_p50": (statistics.median(steps)
                                     if steps else None),
                "prefill_seconds_total": float(sum(self.prefill_seconds)),
                "per_token_seconds_p50": (statistics.median(per_token)
                                          if per_token else None),
                "fill_mean": (statistics.fmean(self.fill)
                              if self.fill else None),
                "sequences": dict(self.sequences),
                "prefix_cache_hits": self.prefix_hits,
                "prefix_cache_evictions": self.prefix_evictions,
                "prefix_cache_shared_pages": self.prefix_shared_pages,
                "spec_proposed_tokens": self.spec_proposed,
                "spec_accepted_tokens": self.spec_accepted,
                # the lifetime acceptance rate, in percent (JAX's gauge)
                "spec_acceptance_rate_pct": (
                    int(100 * self.spec_accepted / self.spec_proposed)
                    if self.spec_proposed else 0),
                "slots_active": self.slots_active,
                "queue_depth": self.queue_depth,
                "queue_stall_us": dict(self.queue_stall_us),
            }
