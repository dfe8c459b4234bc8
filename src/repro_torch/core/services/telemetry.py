"""Event-bus telemetry: the observation half of the adaptive loop.

The paper's controller "monitors the applications and the system state to
adapt the checkpoint strategy at runtime" (§II).  This service is that
observer: it subscribes to the commit / drain / failure / resize events every
subsystem already publishes and maintains per-application estimates —

  * EWMA commit latency and commit size (the Young/Daly commit cost ``C``),
  * EWMA L1→L2 drain throughput,
  * failure inter-arrival times (the MTBF estimate), seeded by a
    configurable prior until real failures are observed,

plus cluster-wide failure counters and on-demand tier occupancy sampled from
the node managers.  Everything is exported two ways: :meth:`snapshot` (a
structured dict for benchmarks / the IntervalController) and
:meth:`prometheus` (Prometheus text exposition format for scraping).

Resize-class events (forewarnings, agent scale-up/down, node add/retake/
migrate) mark the affected apps' commit-cost estimates *stale*: the node set
changed, so the next observed commit replaces the estimate instead of being
blended into it.  That is what lets the IntervalController re-solve quickly
after a reconfiguration.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional

from .. import events as E
from ...obs import LogHistogram
from ..simnet import EWMA
from ..types import AppId

# Prometheus exposition-format naming rules
# (https://prometheus.io/docs/concepts/data_model/): every exported metric
# and label name is validated against these at export time, so a typo'd
# gauge fails tests instead of silently producing an unscrapable line.
_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label_value(value) -> str:
    """Escape a label value per the text exposition format: backslash,
    double-quote and newline must be escaped inside the quotes."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))

# events that mean "the node set / agent set serving an app changed, so the
# commit cost C it observes is about to change too"
RESIZE_EVENTS = (E.RESIZE_FOREWARNED, E.AGENTS_SCALED_UP,
                 E.AGENTS_SCALED_DOWN, E.NODE_ADDED, E.NODE_RETAKEN,
                 E.NODE_MIGRATED, E.CAPACITY_GROW)
# cluster-level failures count against every connected app's MTBF
CLUSTER_FAILURE_EVENTS = (E.NODE_FAILED, E.AGENT_FAILED)
# storage-lifecycle events counted cluster-wide (the lifecycle service's
# observable surface: demotions, trickle completions/failures, retention
# expiries)
LIFECYCLE_EVENTS = (E.SHARD_DEMOTED, E.DEMOTE_FAILED, E.WATERMARK_CROSSED,
                    E.CKPT_IN_L3, E.CKPT_EXPIRED, E.L3_UPLOAD_FAILED)
# erasure-coded durability events, counted cluster-wide (stripe commits,
# peer rebuilds after failures, degraded reads) plus the health monitor's
# own error channel
EC_EVENTS = (E.EC_STRIPE_COMMITTED, E.EC_REBUILD_STARTED, E.EC_REBUILD_DONE,
             E.EC_REBUILD_FAILED, E.EC_DEGRADED_READ, E.MONITOR_ERROR)


class AppTelemetry:
    """Per-application aggregates, all updated from bus events."""

    def __init__(self, alpha: float):
        self.commit_latency_s = EWMA(alpha=alpha)
        self.commit_bytes = EWMA(alpha=alpha)
        self.drain_rate_Bps = EWMA(alpha=alpha)
        self.failure_gap_s = EWMA(alpha=alpha)
        self.commit_latency_sum_s = 0.0      # for the unbiased mean
        self.commits = 0
        self.drains = 0
        self.drain_failures = 0
        self.ckpt_failures = 0
        self.failures = 0
        self.retries = 0
        self.last_commit_t: Optional[float] = None
        self.last_failure_t: Optional[float] = None
        self.commit_cost_stale = False
        # incremental commit path (ckpt_delta_committed / delta_chain_reset)
        self.codec_raw_bytes = 0             # pre-codec bytes, cumulative
        self.codec_encoded_bytes = 0         # bytes-on-wire, cumulative
        self.codec_encode_s = EWMA(alpha=alpha)
        self.delta_key_frames = 0
        self.delta_delta_frames = 0
        self.delta_chain_resets = 0
        # adapt-window redistribution (redistribution_done / _fallback)
        self.redistributions_peer = 0
        self.redistributions_client = 0
        self.redist_fallbacks = 0
        self.redist_bytes_moved = 0          # slice wire bytes, cumulative
        self.redist_bytes_through_client = 0
        self.redist_peer_hops = 0            # agent→agent slice reads
        self.redist_window_s = EWMA(alpha=alpha)
        # analytic max-lane model vs serialized sim-clock wall time of the
        # same window — the gauge CI watches to validate the lane model
        self.redist_window_skew = EWMA(alpha=alpha)
        # zero-stall (two-phase) resize: overlap windows opened, cutovers
        # landed, commits absorbed while streaming, re-hydration fallbacks,
        # and the bounded cutover stall
        self.overlap_windows = 0
        self.overlap_cutovers = 0
        self.overlap_commits = 0
        self.overlap_rehydrations = 0
        self.cutover_stall_s = EWMA(alpha=alpha)
        # restore path (restore_done)
        self.restores = 0
        self.restore_s = EWMA(alpha=alpha)
        # distributions beside the EWMAs: fixed log2 buckets, so p50/p95/
        # p99 and Prometheus _bucket exports are stable across runs
        self.commit_latency_hist = LogHistogram()
        self.commit_bytes_hist = LogHistogram.for_bytes()
        self.drain_hist = LogHistogram()
        self.restore_hist = LogHistogram()
        self.stall_hist = LogHistogram()

    def as_dict(self) -> dict:
        return {
            "commits": self.commits,
            "commit_latency_s": self.commit_latency_s.predict(),
            "mean_commit_latency_s": self.commit_latency_sum_s
            / self.commits if self.commits else 0.0,
            "commit_bytes": self.commit_bytes.predict(),
            "drains": self.drains,
            "drain_rate_Bps": self.drain_rate_Bps.predict(),
            "drain_failures": self.drain_failures,
            "ckpt_failures": self.ckpt_failures,
            "failures": self.failures,
            "retries": self.retries,
            "failure_gap_s": self.failure_gap_s.predict(),
            "commit_cost_stale": self.commit_cost_stale,
            "codec_raw_bytes": self.codec_raw_bytes,
            "codec_encoded_bytes": self.codec_encoded_bytes,
            "codec_compression_ratio": self.codec_raw_bytes
            / self.codec_encoded_bytes if self.codec_encoded_bytes else 1.0,
            "codec_encode_s": self.codec_encode_s.predict(),
            "delta_key_frames": self.delta_key_frames,
            "delta_delta_frames": self.delta_delta_frames,
            "delta_chain_resets": self.delta_chain_resets,
            "redistributions_peer": self.redistributions_peer,
            "redistributions_client": self.redistributions_client,
            "redist_fallbacks": self.redist_fallbacks,
            "redist_bytes_moved": self.redist_bytes_moved,
            "redist_bytes_through_client": self.redist_bytes_through_client,
            "redist_peer_hops": self.redist_peer_hops,
            "redist_window_s": self.redist_window_s.predict(),
            "redist_window_skew": self.redist_window_skew.predict(),
            "overlap_windows": self.overlap_windows,
            "overlap_cutovers": self.overlap_cutovers,
            "overlap_commits": self.overlap_commits,
            "overlap_rehydrations": self.overlap_rehydrations,
            "cutover_stall_s": self.cutover_stall_s.predict(),
            "restores": self.restores,
            "restore_s": self.restore_s.predict(),
            "commit_latency_quantiles": self.commit_latency_hist.as_dict(),
            "commit_bytes_quantiles": self.commit_bytes_hist.as_dict(),
            "drain_quantiles": self.drain_hist.as_dict(),
            "restore_quantiles": self.restore_hist.as_dict(),
            "cutover_stall_quantiles": self.stall_hist.as_dict(),
        }


class TelemetryService:
    """Bus subscriber aggregating the signals the adaptive loop runs on."""

    def __init__(self, ctl, alpha: float = 0.3,
                 default_mtbf_s: float = 3600.0):
        self.ctl = ctl
        self.alpha = float(alpha)
        self.default_mtbf_s = float(default_mtbf_s)
        self._lock = threading.Lock()
        self._apps: Dict[AppId, AppTelemetry] = {}
        self._cluster_failures = 0
        self._events_seen = 0
        # cluster-level per-hop transfer distributions, fed by the SimNIC/
        # MemBus ``on_transfer`` observers the controller wires per node
        self._hop_latency_hist = LogHistogram()
        self._hop_bytes_hist = LogHistogram.for_bytes()
        self._lifecycle = {
            "shard_demotions": 0,
            "demote_failures": 0,
            "watermark_crossings_high": 0,
            "ckpts_in_l3": 0,
            "ckpts_expired": 0,
            "l3_trickle_bytes": 0,
            "l3_upload_failures": 0,
        }
        # erasure-coded durability counters (cluster-level: stripes are an
        # L1 property of the whole store, like demotions)
        self._ec = {
            "stripes_committed": 0,
            "logical_bytes": 0,          # pre-codec payload bytes
            "fragment_bytes": 0,         # k+m fragments on the wire
            "rebuilds_started": 0,
            "rebuilds_done": 0,
            "rebuilds_failed": 0,
            "rebuilds_degraded": 0,      # decode needed parity / lower tier
            "rebuild_bytes": 0,          # payload bytes regenerated
            "degraded_reads": 0,         # fetches that GF-decoded via parity
            "monitor_errors": 0,
        }
        self._ec_rebuild_hist = LogHistogram()
        self._unsubscribe = ctl.bus.subscribe(
            self._on_event,
            events=(E.COMMIT_DONE, E.CKPT_IN_L2, E.DRAIN_FAILED,
                    E.CKPT_FAILED, E.APP_RANK_FAILED, E.APP_REGISTERED,
                    E.CKPT_DELTA_COMMITTED, E.DELTA_CHAIN_RESET,
                    E.REDISTRIBUTION_DONE, E.REDISTRIBUTION_FALLBACK,
                    E.RESIZE_OVERLAP_STARTED, E.CUTOVER_DONE,
                    E.RESTORE_DONE)
            + CLUSTER_FAILURE_EVENTS + RESIZE_EVENTS + LIFECYCLE_EVENTS
            + EC_EVENTS)

    def close(self) -> None:
        self._unsubscribe()

    # ----------------------------------------------------------- ingestion
    def _app(self, app_id: AppId) -> AppTelemetry:
        # callers hold self._lock
        tel = self._apps.get(app_id)
        if tel is None:
            tel = self._apps[app_id] = AppTelemetry(self.alpha)
        return tel

    def _on_event(self, ev: E.Event) -> None:
        with self._lock:
            self._events_seen += 1
            name, p = ev.name, ev.payload
            if name == E.APP_REGISTERED:
                self._app(p["app"])
            elif name == E.COMMIT_DONE:
                tel = self._app(p["app"])
                if tel.commit_cost_stale:
                    # first commit on the new node set: replace, don't blend
                    tel.commit_latency_s = EWMA(self.alpha)
                    tel.commit_bytes = EWMA(self.alpha)
                    tel.commit_cost_stale = False
                tel.commits += 1
                tel.retries += int(p.get("retries", 0))
                tel.commit_latency_sum_s += float(p.get("sim_s", 0.0))
                tel.commit_latency_s.update(float(p.get("sim_s", 0.0)))
                tel.commit_bytes.update(float(p.get("bytes", 0)))
                tel.commit_latency_hist.observe(float(p.get("sim_s", 0.0)))
                tel.commit_bytes_hist.observe(float(p.get("bytes", 0)))
                tel.last_commit_t = ev.sim_t
            elif name == E.CKPT_IN_L2:
                tel = self._app(p["app"])
                tel.drains += 1
                nbytes, sim_s = p.get("bytes"), p.get("sim_s")
                if sim_s is not None:
                    tel.drain_hist.observe(float(sim_s))
                if nbytes and sim_s:
                    tel.drain_rate_Bps.update(float(nbytes) / max(
                        float(sim_s), 1e-12))
            elif name == E.CKPT_DELTA_COMMITTED:
                tel = self._app(p["app"])
                tel.codec_raw_bytes += int(p.get("raw_bytes", 0))
                tel.codec_encoded_bytes += int(p.get("encoded_bytes", 0))
                tel.codec_encode_s.update(float(p.get("encode_s", 0.0)))
                tel.delta_key_frames += int(p.get("key_frames", 0))
                tel.delta_delta_frames += int(p.get("delta_frames", 0))
            elif name == E.DELTA_CHAIN_RESET:
                self._app(p["app"]).delta_chain_resets += 1
            elif name == E.REDISTRIBUTION_DONE:
                tel = self._app(p["app"])
                if p.get("via") == "peer":
                    tel.redistributions_peer += 1
                else:
                    tel.redistributions_client += 1
                tel.redist_bytes_moved += int(p.get("bytes_moved", 0))
                tel.redist_bytes_through_client += \
                    int(p.get("bytes_through_client", 0))
                tel.redist_peer_hops += int(p.get("peer_hops", 0))
                tel.redist_window_s.update(float(p.get("sim_s", 0.0)))
                if "window_skew" in p:
                    tel.redist_window_skew.update(float(p["window_skew"]))
            elif name == E.RESIZE_OVERLAP_STARTED:
                self._app(p["app"]).overlap_windows += 1
            elif name == E.CUTOVER_DONE:
                tel = self._app(p["app"])
                tel.overlap_cutovers += 1
                tel.overlap_commits += int(p.get("overlap_commits", 0))
                tel.overlap_rehydrations += int(bool(p.get("rehydrated")))
                tel.cutover_stall_s.update(float(p.get("stall_sim_s", 0.0)))
                tel.stall_hist.observe(float(p.get("stall_sim_s", 0.0)))
            elif name == E.RESTORE_DONE:
                tel = self._app(p["app"])
                tel.restores += 1
                tel.restore_s.update(float(p.get("sim_s", 0.0)))
                tel.restore_hist.observe(float(p.get("sim_s", 0.0)))
            elif name == E.REDISTRIBUTION_FALLBACK:
                self._app(p["app"]).redist_fallbacks += 1
            elif name == E.DRAIN_FAILED:
                self._app(p["app"]).drain_failures += 1
            elif name == E.CKPT_FAILED:
                self._app(p["app"]).ckpt_failures += 1
            elif name == E.APP_RANK_FAILED:
                self._record_failure(self._app(p["app"]), ev.sim_t)
            elif name in CLUSTER_FAILURE_EVENTS:
                self._cluster_failures += 1
                for tel in self._apps.values():
                    self._record_failure(tel, ev.sim_t)
            elif name == E.SHARD_DEMOTED:
                self._lifecycle["shard_demotions"] += 1
            elif name == E.DEMOTE_FAILED:
                self._lifecycle["demote_failures"] += 1
            elif name == E.WATERMARK_CROSSED:
                if p.get("direction") == "high":
                    self._lifecycle["watermark_crossings_high"] += 1
            elif name == E.CKPT_IN_L3:
                self._lifecycle["ckpts_in_l3"] += 1
                self._lifecycle["l3_trickle_bytes"] += int(p.get("bytes", 0))
            elif name == E.CKPT_EXPIRED:
                self._lifecycle["ckpts_expired"] += 1
            elif name == E.L3_UPLOAD_FAILED:
                self._lifecycle["l3_upload_failures"] += 1
            elif name == E.EC_STRIPE_COMMITTED:
                self._ec["stripes_committed"] += int(p.get("stripes", 0))
                self._ec["logical_bytes"] += int(p.get("logical_bytes", 0))
                self._ec["fragment_bytes"] += int(p.get("fragment_bytes", 0))
            elif name == E.EC_REBUILD_STARTED:
                self._ec["rebuilds_started"] += 1
            elif name == E.EC_REBUILD_DONE:
                self._ec["rebuilds_done"] += 1
                self._ec["rebuilds_degraded"] += int(bool(p.get("degraded")))
                self._ec["rebuild_bytes"] += int(p.get("bytes", 0))
                self._ec_rebuild_hist.observe(float(p.get("sim_s", 0.0)))
            elif name == E.EC_REBUILD_FAILED:
                self._ec["rebuilds_failed"] += 1
            elif name == E.EC_DEGRADED_READ:
                self._ec["degraded_reads"] += 1
            elif name == E.MONITOR_ERROR:
                self._ec["monitor_errors"] += 1
            elif name in RESIZE_EVENTS:
                app_id = p.get("app")
                targets = [self._app(app_id)] if app_id \
                    else list(self._apps.values())
                for tel in targets:
                    tel.commit_cost_stale = True

    def observe_transfer(self, link_name: str, nbytes: int,
                         sim_s: float) -> None:
        """SimNIC/MemBus per-transfer observer: feeds the cluster-level
        peer-hop latency/size histograms (no lock needed — the histograms
        are internally synchronized and hot-path cheap)."""
        self._hop_latency_hist.observe(float(sim_s))
        self._hop_bytes_hist.observe(float(nbytes))

    def _record_failure(self, tel: AppTelemetry, t: float) -> None:
        tel.failures += 1
        if tel.last_failure_t is not None and t > tel.last_failure_t:
            tel.failure_gap_s.update(t - tel.last_failure_t)
        tel.last_failure_t = t

    # ------------------------------------------------------------ estimates
    def commit_cost_s(self, app_id: AppId) -> Optional[float]:
        """EWMA commit cost C (sim seconds), or None before any commit."""
        with self._lock:
            tel = self._apps.get(app_id)
            if tel is None or tel.commits == 0:
                return None
            return tel.commit_latency_s.predict()

    def commit_cost_stale(self, app_id: AppId) -> bool:
        with self._lock:
            tel = self._apps.get(app_id)
            return bool(tel and tel.commit_cost_stale)

    def mtbf_s(self, app_id: AppId) -> float:
        """Failure inter-arrival estimate (sim s); prior until ≥2 failures."""
        with self._lock:
            tel = self._apps.get(app_id)
            if tel is None or tel.failures < 2:
                return self.default_mtbf_s
            return max(tel.failure_gap_s.predict(), 1e-9)

    def drain_rate_Bps(self, app_id: AppId) -> Optional[float]:
        with self._lock:
            tel = self._apps.get(app_id)
            if tel is None or tel.drains == 0:
                return None
            return tel.drain_rate_Bps.predict()

    def app_ids(self) -> List[AppId]:
        with self._lock:
            return list(self._apps)

    # -------------------------------------------------------------- export
    def tier_occupancy(self) -> List[dict]:
        """Per-tier occupancy: node tiers from the managers, plus the shared
        cluster tiers (PFS, and the L3 object store when configured).

        Unbounded tiers report ``capacity_bytes=0`` and ``occupancy=0.0``
        (JSON and Prometheus have no portable infinity).
        """
        rows = []
        for mgr in self.ctl.managers():
            # the managers own the per-node view (same rows the heartbeat
            # carries) — one definition of the occupancy convention
            for r in mgr.tier_occupancy():
                rows.append({"node": mgr.node_id, **r})
        for tier in (getattr(self.ctl, "pfs", None),
                     getattr(self.ctl, "l3", None)):
            if tier is None:
                continue
            cap = tier.capacity
            used = tier.used_bytes
            bounded = cap not in (None, 0) and cap != float("inf")
            rows.append({
                "node": "cluster",
                "tier": tier.name,
                "used_bytes": used,
                "capacity_bytes": cap if bounded else 0,
                "occupancy": used / cap if bounded else 0.0,
            })
        return rows

    def snapshot(self) -> dict:
        """Structured telemetry: per-app estimates + cluster + occupancy."""
        with self._lock:
            per_app = {a: t.as_dict() for a, t in self._apps.items()}
            cluster_failures = self._cluster_failures
            events_seen = self._events_seen
            lifecycle = dict(self._lifecycle)
            ec = dict(self._ec)
            ec["rebuild_quantiles"] = self._ec_rebuild_hist.as_dict()
        for app_id, row in per_app.items():
            row["mtbf_s"] = self.mtbf_s(app_id)
        out = {
            "per_app": per_app,
            "cluster": {
                "failures_total": cluster_failures,
                "events_seen": events_seen,
                "default_mtbf_s": self.default_mtbf_s,
                "peer_hop_quantiles": self._hop_latency_hist.as_dict(),
                "peer_hop_bytes_quantiles": self._hop_bytes_hist.as_dict(),
            },
            "tiers": self.tier_occupancy(),
            "lifecycle": lifecycle,
            "ec": ec,
        }
        l3 = getattr(self.ctl, "l3", None)
        if l3 is not None:
            cost = l3.cost_breakdown()
            cost["total_usd"] = l3.cost_usd()
            out["l3"] = cost
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        snap = self.snapshot()
        out: List[str] = []

        def _labels(labels: Dict[str, object]) -> str:
            for k in labels:
                if not _LABEL_NAME_RE.match(k):
                    raise ValueError(f"invalid Prometheus label name: {k!r}")
            lbl = ",".join(f'{k}="{_escape_label_value(v)}"'
                           for k, v in labels.items())
            return "{" + lbl + "}" if lbl else ""

        def metric(name: str, mtype: str, help_: str, rows) -> None:
            if not _METRIC_NAME_RE.match(name):
                raise ValueError(f"invalid Prometheus metric name: {name!r}")
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {mtype}")
            for labels, value in rows:
                out.append(f"{name}{_labels(labels)} {value:.9g}")

        def histogram(name: str, help_: str, rows) -> None:
            """``rows`` is ``[(labels, LogHistogram), ...]``: emit the
            conventional ``_bucket``/``_sum``/``_count`` series."""
            if not _METRIC_NAME_RE.match(name):
                raise ValueError(f"invalid Prometheus metric name: {name!r}")
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} histogram")
            for labels, hist in rows:
                for le, cum in hist.prometheus_rows():
                    out.append(f"{name}_bucket"
                               f"{_labels({**labels, 'le': le})} {cum:.9g}")
                out.append(f"{name}_sum{_labels(labels)} {hist.sum:.9g}")
                out.append(f"{name}_count{_labels(labels)} {hist.count}")

        apps = snap["per_app"]
        metric("icheck_commits_total", "counter",
               "Completed checkpoint commits per application",
               [({"app": a}, t["commits"]) for a, t in apps.items()])
        metric("icheck_commit_latency_seconds", "gauge",
               "EWMA commit latency (sim seconds)",
               [({"app": a}, t["commit_latency_s"]) for a, t in apps.items()])
        metric("icheck_commit_bytes", "gauge",
               "EWMA checkpoint size per commit",
               [({"app": a}, t["commit_bytes"]) for a, t in apps.items()])
        metric("icheck_drain_throughput_bytes_per_second", "gauge",
               "EWMA L1->L2 drain throughput",
               [({"app": a}, t["drain_rate_Bps"]) for a, t in apps.items()])
        metric("icheck_codec_compression_ratio", "gauge",
               "Raw/encoded bytes-on-wire ratio of the q8-delta commit path",
               [({"app": a}, t["codec_compression_ratio"])
                for a, t in apps.items()])
        metric("icheck_codec_encode_seconds", "gauge",
               "EWMA host-clock commit encode time (device+pack)",
               [({"app": a}, t["codec_encode_s"]) for a, t in apps.items()])
        metric("icheck_codec_bytes_total", "counter",
               "Commit-path codec bytes (pre-codec raw vs on-wire encoded)",
               [({"app": a, "kind": kind}, t[f"codec_{kind}_bytes"])
                for a, t in apps.items() for kind in ("raw", "encoded")])
        metric("icheck_delta_frames_total", "counter",
               "q8-delta frames committed, by kind",
               [({"app": a, "kind": kind}, t[f"delta_{kind}_frames"])
                for a, t in apps.items() for kind in ("key", "delta")])
        metric("icheck_delta_chain_resets_total", "counter",
               "Delta chains invalidated (resize/failure/demotion/expiry)",
               [({"app": a}, t["delta_chain_resets"])
                for a, t in apps.items()])
        metric("icheck_redistributions_total", "counter",
               "Adapt-window redistributions, by data path",
               [({"app": a, "via": via}, t[f"redistributions_{via}"])
                for a, t in apps.items() for via in ("peer", "client")])
        metric("icheck_redist_fallbacks_total", "counter",
               "Peer redistributions that fell back to the client funnel",
               [({"app": a}, t["redist_fallbacks"]) for a, t in apps.items()])
        metric("icheck_redist_bytes_total", "counter",
               "Redistribution bytes: slice wire bytes moved vs bytes "
               "funnelled through the client",
               [({"app": a, "kind": kind}, t[f"redist_bytes_{kind}"])
                for a, t in apps.items()
                for kind in ("moved", "through_client")])
        metric("icheck_redist_peer_hops_total", "counter",
               "Agent-to-agent slice reads executed during adapt windows",
               [({"app": a}, t["redist_peer_hops"]) for a, t in apps.items()])
        metric("icheck_redist_window_seconds", "gauge",
               "EWMA simulated adapt-window redistribution time",
               [({"app": a}, t["redist_window_s"]) for a, t in apps.items()])
        metric("icheck_redist_window_skew_ratio", "gauge",
               "EWMA analytic-max-lane / sim-clock-wall ratio of the adapt "
               "window (validates the CommitHandle lane model)",
               [({"app": a}, t["redist_window_skew"])
                for a, t in apps.items()])
        metric("icheck_overlap_windows_total", "counter",
               "Zero-stall resize overlap windows opened",
               [({"app": a}, t["overlap_windows"]) for a, t in apps.items()])
        metric("icheck_overlap_cutovers_total", "counter",
               "Zero-stall resize cutovers landed",
               [({"app": a}, t["overlap_cutovers"]) for a, t in apps.items()])
        metric("icheck_overlap_commits_total", "counter",
               "Commits absorbed while overlap windows streamed",
               [({"app": a}, t["overlap_commits"]) for a, t in apps.items()])
        metric("icheck_overlap_rehydrations_total", "counter",
               "Cutovers that re-hydrated from the head instead of "
               "replaying the tail (chain reset raced the window)",
               [({"app": a}, t["overlap_rehydrations"])
                for a, t in apps.items()])
        metric("icheck_cutover_stall_seconds", "gauge",
               "EWMA bounded cutover stall (tail replay + patch fetch)",
               [({"app": a}, t["cutover_stall_s"]) for a, t in apps.items()])
        metric("icheck_failures_total", "counter",
               "Failures charged to each application",
               [({"app": a}, t["failures"]) for a, t in apps.items()])
        metric("icheck_mtbf_seconds", "gauge",
               "Failure inter-arrival estimate (sim seconds)",
               [({"app": a}, t["mtbf_s"]) for a, t in apps.items()])
        metric("icheck_cluster_failures_total", "counter",
               "Cluster-level node/agent failures",
               [({}, snap["cluster"]["failures_total"])])
        metric("icheck_tier_used_bytes", "gauge",
               "Bytes resident per storage tier (node tiers + shared tiers)",
               [({"node": r["node"], "tier": r["tier"]}, r["used_bytes"])
                for r in snap["tiers"]])
        metric("icheck_tier_occupancy_ratio", "gauge",
               "Fill fraction per storage tier (0 for unbounded tiers)",
               [({"node": r["node"], "tier": r["tier"]}, r["occupancy"])
                for r in snap["tiers"]])
        life = snap["lifecycle"]
        metric("icheck_shard_demotions_total", "counter",
               "Shards pushed down a tier by the watermark policy",
               [({}, life["shard_demotions"])])
        metric("icheck_demote_failures_total", "counter",
               "Demotions that could not happen (observable reasons on bus)",
               [({}, life["demote_failures"])])
        metric("icheck_watermark_crossings_total", "counter",
               "High-watermark crossings that triggered demotion",
               [({}, life["watermark_crossings_high"])])
        metric("icheck_ckpts_in_l3_total", "counter",
               "Checkpoints trickled into the remote object store",
               [({}, life["ckpts_in_l3"])])
        metric("icheck_l3_upload_failures_total", "counter",
               "L2->L3 trickles that exhausted their retries",
               [({}, life["l3_upload_failures"])])
        metric("icheck_ckpts_expired_total", "counter",
               "Checkpoint copies dropped by retention/GC",
               [({}, life["ckpts_expired"])])
        ec = snap["ec"]
        metric("icheck_ec_stripes_committed_total", "counter",
               "Erasure stripes committed to L1 (k data + m parity each)",
               [({}, ec["stripes_committed"])])
        metric("icheck_ec_bytes_total", "counter",
               "Erasure-coded bytes: logical payload vs k+m fragments",
               [({"kind": "logical"}, ec["logical_bytes"]),
                ({"kind": "fragment"}, ec["fragment_bytes"])])
        metric("icheck_ec_rebuilds_total", "counter",
               "Peer stripe rebuilds after failures, by outcome",
               [({"outcome": "started"}, ec["rebuilds_started"]),
                ({"outcome": "done"}, ec["rebuilds_done"]),
                ({"outcome": "failed"}, ec["rebuilds_failed"]),
                ({"outcome": "degraded"}, ec["rebuilds_degraded"])])
        metric("icheck_ec_rebuild_bytes_total", "counter",
               "Payload bytes regenerated by stripe rebuilds",
               [({}, ec["rebuild_bytes"])])
        metric("icheck_ec_degraded_reads_total", "counter",
               "Shard fetches that GF-decoded via parity fragments",
               [({}, ec["degraded_reads"])])
        metric("icheck_monitor_errors_total", "counter",
               "Health-monitor poll loops that raised (see flight dumps)",
               [({}, ec["monitor_errors"])])
        l3 = snap.get("l3")
        if l3 is not None:
            metric("icheck_l3_cost_usd", "gauge",
                   "Accumulated object-store bill (requests + bytes)",
                   [({}, l3["total_usd"])])
            metric("icheck_l3_bytes_total", "counter",
                   "Bytes moved to/from the object store",
                   [({"direction": "in"}, l3["bytes_in"]),
                    ({"direction": "out"}, l3["bytes_out"])])
            metric("icheck_l3_requests_total", "counter",
                   "Object-store requests issued",
                   [({"op": "put"}, l3["put_requests"]),
                    ({"op": "get"}, l3["get_requests"])])
        # latency/size distributions: fixed log2 buckets (stable ``le``
        # labels), p50/p95/p99 derivable by any scraper
        with self._lock:
            app_hists = {a: t for a, t in self._apps.items()}
            hop_lat, hop_bytes = self._hop_latency_hist, self._hop_bytes_hist
            ec_rebuild_hist = self._ec_rebuild_hist
        histogram("icheck_commit_seconds",
                  "Commit latency distribution (sim seconds)",
                  [({"app": a}, t.commit_latency_hist)
                   for a, t in app_hists.items()])
        histogram("icheck_commit_size_bytes",
                  "Committed checkpoint size distribution",
                  [({"app": a}, t.commit_bytes_hist)
                   for a, t in app_hists.items()])
        histogram("icheck_drain_seconds",
                  "L1->L2 drain duration distribution (sim seconds)",
                  [({"app": a}, t.drain_hist)
                   for a, t in app_hists.items()])
        histogram("icheck_restore_seconds",
                  "Restore duration distribution (sim seconds)",
                  [({"app": a}, t.restore_hist)
                   for a, t in app_hists.items()])
        histogram("icheck_stall_seconds",
                  "Zero-stall cutover stall distribution (sim seconds)",
                  [({"app": a}, t.stall_hist)
                   for a, t in app_hists.items()])
        histogram("icheck_peer_hop_seconds",
                  "Per-transfer NIC/MemBus hop duration (sim seconds)",
                  [({}, hop_lat)])
        histogram("icheck_peer_hop_bytes",
                  "Per-transfer NIC/MemBus hop size",
                  [({}, hop_bytes)])
        histogram("icheck_ec_rebuild_seconds",
                  "Stripe rebuild duration distribution (sim seconds)",
                  [({}, ec_rebuild_hist)])
        return "\n".join(out) + "\n"
