"""Per-priority-class SLOs: declarative objectives, multi-window burn rates,
error-budget accounting, and the /sloz document.

Two objectives per admission class (critical / batch / best_effort):

- **availability** — the fraction of Solve RPCs answering neither shed
  nor error.  Sheds count against the objective on purpose: admission
  control protecting the *fleet* is still the *caller's* unavailability,
  and the budget is exactly how much of it the class tolerates
  (``KT_SLO_AVAIL_TARGET``, default 0.999).
- **latency** — the fraction of served solves completing within
  ``KT_SLO_P99_MS`` (default 250 ms, the paper's p99 budget), targeted
  at ``KT_SLO_LATENCY_TARGET`` (default 0.99).  Windowed numbers come
  from histogram-bucket deltas, so a latency regression shows up within
  one window rather than being averaged into the lifetime histogram.

Each objective is judged as burn rates over multiple windows (the SRE
multi-window multi-burn-rate alerting shape): ``burn = bad-fraction /
budget``, so 1.0 spends exactly the budget over that window and
``KT_SLO_FAST_BURN`` (default 14, the classic page threshold) on the
short window means the budget dies in hours.  The verdict ladder is
``no_data`` (no traffic yet) < ``ok`` < ``warn`` (any window burning
faster than budget) < ``breach`` (budget exhausted, or fast-burn).

The engine is registry-backed (``karpenter_slo_*`` families, KT003
zero-initialized) so /metrics scrapes the same numbers /sloz serves,
and :func:`merge_sloz` recomputes fleet-wide burn rates from summed
per-replica numerators/denominators — burn rates do not average.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

from .. import metrics as M
from ..utils.clock import Clock
from .trace import replica_id

#: availability objective target (good fraction), per class
AVAIL_TARGET_ENV = "KT_SLO_AVAIL_TARGET"
#: latency objective target (fraction of serves under the threshold)
LATENCY_TARGET_ENV = "KT_SLO_LATENCY_TARGET"
#: the latency threshold itself, milliseconds
P99_MS_ENV = "KT_SLO_P99_MS"
#: short-window burn rate that escalates warn -> breach
FAST_BURN_ENV = "KT_SLO_FAST_BURN"
DEFAULT_AVAIL_TARGET = 0.999
DEFAULT_LATENCY_TARGET = 0.99
DEFAULT_P99_MS = 250.0
DEFAULT_FAST_BURN = 14.0

#: the burn-rate evaluation windows, (label, seconds); labels are the
#: metrics.SLO_WINDOW_NAMES population
WINDOWS = (("5m", 300.0), ("1h", 3600.0))

VERDICTS = ("no_data", "ok", "warn", "breach")
_VERDICT_NUM = {"no_data": -1.0, "ok": 0.0, "warn": 1.0, "breach": 2.0}


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class SloEngine:
    """Records per-RPC outcomes and evaluates the objectives.

    ``record()`` sits on the Solve path (two dict increments — no lock,
    no window math); ``evaluate()`` does all the window work and is
    called from /sloz, the replay harness, and the fleet merge.
    """

    def __init__(self, registry, sampler=None, clock: Optional[Clock] = None,
                 replica: str = "",
                 avail_target: Optional[float] = None,
                 latency_target: Optional[float] = None,
                 p99_ms: Optional[float] = None,
                 fast_burn: Optional[float] = None) -> None:
        self.registry = registry
        self.sampler = sampler
        self.clock = clock or Clock()
        self.replica = replica or replica_id()
        self.avail_target = (avail_target if avail_target is not None
                             else _env_float(AVAIL_TARGET_ENV,
                                             DEFAULT_AVAIL_TARGET))
        self.latency_target = (latency_target if latency_target is not None
                               else _env_float(LATENCY_TARGET_ENV,
                                               DEFAULT_LATENCY_TARGET))
        self.p99_ms = (p99_ms if p99_ms is not None
                       else _env_float(P99_MS_ENV, DEFAULT_P99_MS))
        self.fast_burn = (fast_burn if fast_burn is not None
                          else _env_float(FAST_BURN_ENV, DEFAULT_FAST_BURN))
        requests = registry.counter(M.SLO_REQUESTS)
        for cls in M.SLO_CLASSES:
            for outcome in M.SLO_REQUEST_OUTCOMES:
                requests.inc({"class": cls, "outcome": outcome}, 0.0)
        hist = registry.histogram(M.SLO_LATENCY)
        for cls in M.SLO_CLASSES:
            # touch the per-class series into existence (defaultdicts):
            # the sampler's very first tick then records a zero anchor,
            # so the FIRST latency observation of a class is already
            # windowable one tick later — the KT003 rationale, applied
            # to a histogram
            lkey = M._lkey({"class": cls})
            hist.counts[lkey], hist.sums[lkey], hist.totals[lkey]  # noqa: B018
        burn = registry.gauge(M.SLO_BURN_RATE)
        budget = registry.gauge(M.SLO_BUDGET_REMAINING)
        verdict = registry.gauge(M.SLO_VERDICT)
        for cls in M.SLO_CLASSES:
            verdict.set(_VERDICT_NUM["no_data"], {"class": cls})
            for obj in M.SLO_OBJECTIVES:
                budget.set(1.0, {"class": cls, "objective": obj})
                for win, _ in WINDOWS:
                    burn.set(0.0, {"class": cls, "objective": obj,
                                   "window": win})

    # ---- recording (hot path) ----------------------------------------

    def record(self, pclass: str, outcome: str,
               solve_ms: Optional[float] = None) -> None:
        """Account one Solve RPC.  outcome in SLO_REQUEST_OUTCOMES;
        solve_ms only for served requests (feeds the latency objective)."""
        if pclass not in M.SLO_CLASSES:
            pclass = "batch"
        if outcome not in M.SLO_REQUEST_OUTCOMES:
            outcome = "error"
        self.registry.counter(M.SLO_REQUESTS).inc(
            {"class": pclass, "outcome": outcome})
        if solve_ms is not None and outcome == "ok":
            self.registry.histogram(M.SLO_LATENCY).observe(
                solve_ms / 1000.0, {"class": pclass})

    # ---- evaluation --------------------------------------------------

    def _lifetime(self, cls: str):
        """(availability total/bad, latency total/bad) from the lifetime
        registry state — the budget-remaining denominator."""
        req = self.registry.counter(M.SLO_REQUESTS)
        ok = req.get({"class": cls, "outcome": "ok"})
        shed = req.get({"class": cls, "outcome": "shed"})
        err = req.get({"class": cls, "outcome": "error"})
        hist = self.registry.histogram(M.SLO_LATENCY)
        lkey = M._lkey({"class": cls})
        total = hist.totals.get(lkey, 0)
        counts = hist.counts.get(lkey)
        lat_bad = (total - self._good_count(counts, hist.buckets)
                   if counts is not None else 0)
        return (ok + shed + err, shed + err), (total, lat_bad)

    def _good_count(self, counts, buckets) -> int:
        thr = self.p99_ms / 1000.0
        good = 0
        for i, b in enumerate(buckets):
            if b <= thr + 1e-12 and i < len(counts):
                good += counts[i]
        return good

    def _avail_window(self, cls: str, window_s: float):
        """(total, bad) over the window from sampler counter increases,
        or None without sampler history."""
        if not self.sampler:
            return None
        vals = {}
        for outcome in M.SLO_REQUEST_OUTCOMES:
            inc = self.sampler.increase(
                M.SLO_REQUESTS, {"class": cls, "outcome": outcome},
                window_s=window_s)
            if inc is None:
                return None
            vals[outcome] = inc
        total = sum(vals.values())
        return total, vals["shed"] + vals["error"]

    def _latency_window(self, cls: str, window_s: float):
        if not self.sampler:
            return None
        hw = self.sampler.hist_window(M.SLO_LATENCY, {"class": cls},
                                      window_s=window_s)
        if hw is None:
            return None
        deltas, _, count, buckets = hw
        if count <= 0:
            return 0, 0
        return count, count - self._good_count(deltas, buckets)

    @staticmethod
    def _burn(total: float, bad: float, target: float) -> Optional[float]:
        if total <= 0:
            return None
        budget = 1.0 - target
        if budget <= 0:
            return float("inf") if bad else 0.0
        return (bad / total) / budget

    def _objective_doc(self, cls: str, objective: str, target: float,
                       lifetime, window_fn) -> dict:
        total, bad = lifetime
        budget = 1.0 - target
        if total > 0 and budget > 0:
            remaining = 1.0 - (bad / total) / budget
        else:
            remaining = 1.0
        windows = {}
        for win, secs in WINDOWS:
            w = window_fn(cls, secs)
            if w is None:
                windows[win] = None
                continue
            w_total, w_bad = w
            windows[win] = {
                "total": w_total, "bad": w_bad,
                "burn_rate": self._burn(w_total, w_bad, target),
            }
        return {"target": target,
                "lifetime": {"total": total, "bad": bad},
                "budget_remaining": remaining,
                "windows": windows}

    @staticmethod
    def _verdict(cls_doc: dict, fast_burn: float) -> str:
        objs = [cls_doc["availability"], cls_doc["latency"]]
        if all(o["lifetime"]["total"] <= 0 for o in objs):
            return "no_data"
        short = WINDOWS[0][0]
        worst = "ok"
        for o in objs:
            if o["budget_remaining"] <= 0:
                return "breach"
            w = o["windows"].get(short)
            if w and w["burn_rate"] is not None \
                    and w["burn_rate"] >= fast_burn:
                return "breach"
            for w in o["windows"].values():
                if w and w["burn_rate"] is not None \
                        and w["burn_rate"] >= 1.0:
                    worst = "warn"
        return worst

    def evaluate(self) -> dict:
        """Build the /sloz document and refresh the karpenter_slo_*
        gauges from it."""
        doc: dict = {
            "replica_id": self.replica,
            "at": self.clock.now(),
            "config": {"avail_target": self.avail_target,
                       "latency_target": self.latency_target,
                       "p99_ms": self.p99_ms,
                       "fast_burn": self.fast_burn},
            "windows": {win: secs for win, secs in WINDOWS},
            "classes": {},
        }
        burn_g = self.registry.gauge(M.SLO_BURN_RATE)
        budget_g = self.registry.gauge(M.SLO_BUDGET_REMAINING)
        verdict_g = self.registry.gauge(M.SLO_VERDICT)
        for cls in M.SLO_CLASSES:
            avail_life, lat_life = self._lifetime(cls)
            cls_doc = {
                "availability": self._objective_doc(
                    cls, "availability", self.avail_target, avail_life,
                    self._avail_window),
                "latency": self._objective_doc(
                    cls, "latency", self.latency_target, lat_life,
                    self._latency_window),
            }
            cls_doc["latency"]["threshold_ms"] = self.p99_ms
            cls_doc["verdict"] = self._verdict(cls_doc, self.fast_burn)
            doc["classes"][cls] = cls_doc
            verdict_g.set(_VERDICT_NUM[cls_doc["verdict"]], {"class": cls})
            for obj in M.SLO_OBJECTIVES:
                o = cls_doc[obj]
                budget_g.set(o["budget_remaining"],
                             {"class": cls, "objective": obj})
                for win, _ in WINDOWS:
                    w = o["windows"].get(win)
                    rate = w["burn_rate"] if w else None
                    burn_g.set(rate if rate is not None else 0.0,
                               {"class": cls, "objective": obj,
                                "window": win})
        return doc


def merge_sloz(docs: Iterable[dict]) -> dict:
    """Fleet-wide SLO view: sum per-replica numerators/denominators per
    class/objective (lifetime and per-window), recompute burn rates and
    verdicts from the sums.  Burn rates are ratios — they merge by
    re-division, never by averaging.  Config comes from the first doc
    (replicas share knobs by deployment)."""
    docs = [d for d in docs if isinstance(d, dict) and d.get("classes")]
    if not docs:
        return {}
    config = docs[0].get("config", {})
    fast_burn = float(config.get("fast_burn", DEFAULT_FAST_BURN))
    targets = {"availability": float(config.get("avail_target",
                                                DEFAULT_AVAIL_TARGET)),
               "latency": float(config.get("latency_target",
                                           DEFAULT_LATENCY_TARGET))}
    out: dict = {"config": config,
                 "windows": docs[0].get("windows",
                                        {w: s for w, s in WINDOWS}),
                 "replicas": {}, "classes": {}}
    for d in docs:
        rid = d.get("replica_id", "?")
        out["replicas"][rid] = {
            cls: info.get("verdict", "no_data")
            for cls, info in (d.get("classes") or {}).items()}
    for cls in M.SLO_CLASSES:
        cls_doc: Dict[str, dict] = {}
        for obj in M.SLO_OBJECTIVES:
            target = targets[obj]
            life_total = life_bad = 0.0
            win_sums: Dict[str, Optional[list]] = {
                win: [0.0, 0.0] for win, _ in WINDOWS}
            for d in docs:
                info = (d.get("classes") or {}).get(cls)
                if not info or obj not in info:
                    continue
                o = info[obj]
                life = o.get("lifetime") or {}
                life_total += float(life.get("total", 0) or 0)
                life_bad += float(life.get("bad", 0) or 0)
                for win, _ in WINDOWS:
                    w = (o.get("windows") or {}).get(win)
                    tgt = win_sums[win]
                    if w is None or tgt is None:
                        continue
                    tgt[0] += float(w.get("total", 0) or 0)
                    tgt[1] += float(w.get("bad", 0) or 0)
            budget = 1.0 - target
            remaining = (1.0 - (life_bad / life_total) / budget
                         if life_total > 0 and budget > 0 else 1.0)
            windows = {}
            for win, _ in WINDOWS:
                t, b = win_sums[win]
                if t <= 0:
                    windows[win] = ({"total": 0, "bad": 0,
                                     "burn_rate": None}
                                    if any_window(docs, cls, obj, win)
                                    else None)
                else:
                    windows[win] = {
                        "total": t, "bad": b,
                        "burn_rate": SloEngine._burn(t, b, target)}
            cls_doc[obj] = {"target": target,
                            "lifetime": {"total": life_total,
                                         "bad": life_bad},
                            "budget_remaining": remaining,
                            "windows": windows}
        cls_doc["latency"]["threshold_ms"] = float(
            config.get("p99_ms", DEFAULT_P99_MS))
        cls_doc["verdict"] = SloEngine._verdict(cls_doc, fast_burn)
        out["classes"][cls] = cls_doc
    return out


def any_window(docs, cls: str, obj: str, win: str) -> bool:
    """Whether any replica had sampler history for the window (so the
    merged doc distinguishes 'no sampler anywhere' (None) from 'history
    but zero traffic')."""
    for d in docs:
        info = (d.get("classes") or {}).get(cls) or {}
        o = info.get(obj) or {}
        if ((o.get("windows") or {}).get(win)) is not None:
            return True
    return False
