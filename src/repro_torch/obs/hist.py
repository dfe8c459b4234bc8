"""Fixed-bucket log2 histograms for latency/size distributions.

The telemetry EWMAs answer "what is the current estimate"; these answer
"where did the mass go" — the p50/p95/p99 the ROADMAP's QoS scheduler
needs.  Buckets are *fixed* powers of two (no dynamic rebucketing), so
the Prometheus ``le`` labels are stable across scrapes and across runs,
and two histograms of the same family are always mergeable.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple


class LogHistogram:
    """Counts per power-of-two bucket, with interpolated quantiles.

    ``lo_exp``/``hi_exp`` bound the bucket upper edges ``2**e`` for
    ``e in [lo_exp, hi_exp]``; values above ``2**hi_exp`` land in the
    overflow (``+Inf``) bucket.  Defaults cover ~1 µs .. ~1 h of sim
    seconds; use ``LogHistogram.for_bytes()`` for size distributions.
    """

    def __init__(self, lo_exp: int = -20, hi_exp: int = 12):
        self.bounds: Tuple[float, ...] = tuple(
            float(2.0 ** e) for e in range(int(lo_exp), int(hi_exp) + 1))
        self._counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    @classmethod
    def for_bytes(cls) -> "LogHistogram":
        return cls(lo_exp=6, hi_exp=44)      # 64 B .. 16 TiB

    # ------------------------------------------------------------ recording
    def _bucket_index(self, value: float) -> int:
        lo, hi = 0, len(self.bounds)
        while lo < hi:                       # first bound >= value
            mid = (lo + hi) // 2
            if self.bounds[mid] < value:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def observe(self, value: float) -> None:
        v = max(0.0, float(value))
        idx = self._bucket_index(v)
        with self._lock:
            self._counts[idx] += 1
            self.sum += v
            self.count += 1

    # ------------------------------------------------------------ reading
    def counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)

    def quantile(self, q: float) -> float:
        """Linear interpolation inside the target bucket (0 when empty)."""
        with self._lock:
            total = self.count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        rank = max(0.0, min(1.0, float(q))) * total
        seen = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= rank:
                frac = (rank - seen) / c
                hi = self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1] * 2.0
                lo = self.bounds[i - 1] if i > 0 else 0.0
                return lo + frac * (hi - lo)
            seen += c
        return self.bounds[-1] * 2.0

    def quantiles(self, qs: Sequence[float] = (0.5, 0.95, 0.99)
                  ) -> Dict[str, float]:
        return {f"p{int(q * 100)}": self.quantile(q) for q in qs}

    def as_dict(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self.count, self.sum
        out = {"count": total, "sum": s}
        if total:
            out.update(self.quantiles())
        return out

    def prometheus_rows(self) -> List[Tuple[str, float]]:
        """Cumulative ``(le, count)`` rows ending in ``+Inf`` — the
        Prometheus histogram bucket contract."""
        with self._lock:
            counts = list(self._counts)
        rows: List[Tuple[str, float]] = []
        cum = 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            rows.append((f"{bound:.9g}", float(cum)))
        rows.append(("+Inf", float(cum + counts[-1])))
        return rows
