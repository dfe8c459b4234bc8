"""Adaptive checkpoint-interval control (Young/Daly over live telemetry).

Closes the loop the paper calls adaptive checkpoint management: instead of a
static ``ckpt_interval_s`` chosen at registration, the controller re-solves
each application's optimal checkpoint cadence from the TelemetryService's
estimates of commit cost ``C`` and mean time between failures ``M``
(cf. the malleable-interval determination of arXiv:1711.00270):

  Young (1974):  T = sqrt(2*C*M)
  Daly  (2006):  T = sqrt(2*C*M) * (1 + sqrt(C/(2M))/3 + (C/(2M))/9) - C
                 for C < 2M, else T = M

Solutions are published as :data:`~..events.INTERVAL_CHANGED` events and
written back into the controller's :class:`AppRecord` (so scheduling
policies see the app's true demand).  ``ICheckClient`` and the elastic
trainer subscribe and re-pace their commits mid-run.

Triggers:
  * every completed commit (C estimate moved),
  * every failure event (M estimate moved),
  * every resize-class event — these *force* a re-solve and publish even
    inside the hysteresis band, because the commit cost changes with the
    node set and downstream consumers must hear about it promptly.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional

from .. import events as E
from ..types import AppId
from .telemetry import CLUSTER_FAILURE_EVENTS, RESIZE_EVENTS, TelemetryService


def young_interval(commit_cost_s: float, mtbf_s: float) -> float:
    """Young's first-order optimum: sqrt(2*C*M)."""
    return math.sqrt(2.0 * max(commit_cost_s, 0.0) * max(mtbf_s, 1e-12))


def daly_interval(commit_cost_s: float, mtbf_s: float) -> float:
    """Daly's higher-order refinement of Young's formula.

    For C < 2M:  sqrt(2CM) * (1 + (1/3)sqrt(C/2M) + (1/9)(C/2M)) - C
    otherwise the machine fails faster than it checkpoints: T = M.
    """
    c = max(commit_cost_s, 0.0)
    m = max(mtbf_s, 1e-12)
    if c >= 2.0 * m:
        return m
    x = c / (2.0 * m)
    return young_interval(c, m) * (1.0 + math.sqrt(x) / 3.0 + x / 9.0) - c


class IntervalController:
    """Bus-driven Young/Daly solver publishing ``INTERVAL_CHANGED`` events."""

    def __init__(self, ctl, telemetry: TelemetryService,
                 min_interval_s: float = 1e-3,
                 max_interval_s: float = 86400.0,
                 hysteresis: float = 0.1, use_daly: bool = True):
        self.ctl = ctl
        self.telemetry = telemetry
        self.min_interval_s = float(min_interval_s)
        self.max_interval_s = float(max_interval_s)
        self.hysteresis = float(hysteresis)
        self.use_daly = bool(use_daly)
        self._lock = threading.Lock()
        self._solved: Dict[AppId, float] = {}
        self.resolves = 0
        self.publishes = 0
        self._unsubscribe = ctl.bus.subscribe(
            self._on_event,
            events=(E.COMMIT_DONE, E.APP_RANK_FAILED)
            + CLUSTER_FAILURE_EVENTS + RESIZE_EVENTS)

    def close(self) -> None:
        self._unsubscribe()

    # -------------------------------------------------------------- solving
    def solve(self, commit_cost_s: float, mtbf_s: float) -> float:
        t = daly_interval(commit_cost_s, mtbf_s) if self.use_daly \
            else young_interval(commit_cost_s, mtbf_s)
        return min(max(t, self.min_interval_s), self.max_interval_s)

    def interval_for(self, app_id: AppId) -> Optional[float]:
        """Last solved interval for the app (None before first solve)."""
        with self._lock:
            return self._solved.get(app_id)

    def resolve(self, app_id: AppId, force: bool = False,
                reason: str = "resolve") -> Optional[float]:
        """Re-solve one app's interval; publish if it moved (or ``force``)."""
        cost = self.telemetry.commit_cost_s(app_id)
        if cost is None:
            return None                       # nothing observed yet
        mtbf = self.telemetry.mtbf_s(app_id)
        target = self.solve(cost, mtbf)
        with self._lock:
            self.resolves += 1
        ctl = self.ctl
        with ctl._lock:
            app = ctl._apps.get(app_id)
            if app is None:
                return None
            prev = app.ckpt_interval_s
            changed = abs(target - prev) > self.hysteresis * max(prev, 1e-12)
            if changed or force:
                app.ckpt_interval_s = target
        with self._lock:
            self._solved[app_id] = target
        if changed or force:
            with self._lock:
                self.publishes += 1
            ctl.bus.publish(E.INTERVAL_CHANGED, app=app_id,
                            interval_s=target, prev_interval_s=prev,
                            commit_cost_s=cost, mtbf_s=mtbf, reason=reason)
        return target

    def resolve_all(self, force: bool = False, reason: str = "resolve") -> None:
        for app_id in self.telemetry.app_ids():
            self.resolve(app_id, force=force, reason=reason)

    # --------------------------------------------------------------- events
    def _on_event(self, ev: E.Event) -> None:
        name, p = ev.name, ev.payload
        if name == E.COMMIT_DONE:
            self.resolve(p["app"], reason="commit")
        elif name == E.APP_RANK_FAILED:
            self.resolve(p["app"], reason="failure")
        elif name in CLUSTER_FAILURE_EVENTS:
            self.resolve_all(reason="failure")
        elif name in RESIZE_EVENTS:
            # the node set changed: commit cost C is about to move, so the
            # solution must be re-published even inside the hysteresis band
            app_id = p.get("app")
            if app_id:
                self.resolve(app_id, force=True, reason="resize")
            else:
                self.resolve_all(force=True, reason="resize")
