"""The benchmark's core: find a cell by its name, drive it, judge it.

``BENCHMARK.json`` names each cell's configuration and traffic; the
harness reads the configuration's file, ``traffic/<traffic>.json``, the
driver ``drivers/<entry>.py`` that the traffic names, and one reader
``metrics/<metric>.py`` for every metric the cell reports.  Adding a
cell, a traffic mix or a metric adds files and entries, never an edit.

A run (:func:`run_cell`): the inputs from ``--seed``, with every offer
the run will make copied ahead, the driver's set-up and warm-up at the
cell's own shapes, the window, with ``--trace 1`` a profiled stretch
after it, the device's memory peak, the program's state freed, then the
reference: its own plan of every pending set the window offered, and a
check of every plan the program returned.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from . import catalog, reference, roofline, tracing, workload

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules a run must not load (compared whole: the port's name
#: begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "karpenter_tpu")
OUT_DIR = ROOT / "chiprun_out" / "benchmark"


@dataclass
class Request:
    """One request of a run: the set it offered under the tag of its
    pods' names, its pods, its host interval, its spans (traced runs),
    and its answer: ``result`` (the program's, turned into the plain
    records of ``plan`` after the run), or ``error``."""

    set: int
    tag: str
    pods: int
    t0: float
    t1: float
    trace: Optional[tracing.ReqTrace] = None
    plan: Optional[dict] = None
    result: object = None
    error: Optional[str] = None

    @property
    def spans(self) -> list:
        return self.trace.spans if self.trace is not None else []


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``
    returns a number, or None where the run has nothing to read): the
    window's requests, the costs of both sides' plans, the change of the
    program's histograms over the window (``hist_delta``: name to sum
    and count, for a counter's reader) and the profiled stretch."""

    window: list
    window_s: float
    setup_s: float
    cost_program: float = 0.0
    cost_reference: float = 0.0
    hist_delta: dict = field(default_factory=dict)
    profile: Optional[dict] = None

    @property
    def served(self) -> list:
        return [r for r in self.window if r.error is None]


# ---------------------------------------------------------------------------
# the manifest and the files it names
# ---------------------------------------------------------------------------


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _lists(metric: dict, name: str, reported: set) -> bool:
    if "workloads" in metric:
        return name in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def cell(man: dict, name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration, traffic and metrics."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = {c["name"]: c for c in man["configs"]}[w["config"]]
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in man["end_to_end"] if _lists(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if _lists(m, name, reported)]
    return {"name": name, "chips": w["chips"], "config": config,
            "traffic": traffic, "end_to_end": e2e, "per_layer": per_layer}


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_class(entry: str):
    return importlib.import_module(f"{__package__}.drivers.{entry}").Driver


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


class Context:
    """The inputs both sides get: the catalog's records, the
    provisioner and the pending sets, and the program's objects made
    from them: among those the fresh pod objects of the warm-up's offer,
    of ``offers`` more for the window and of the profiled stretch's,
    copied in set-up and handed out in turn by :meth:`next_offer`."""

    def __init__(self, c: dict, seed: int, device) -> None:
        from . import inputs

        config, self.traffic = c["config"], c["traffic"]
        self.device = device
        records = catalog.generate(full=config["catalog"]["full"])
        self.candidates = reference.Candidates(
            records, config["provisioner"], catalog.ZONES)
        self.sets = workload.pending_sets(config, self.traffic, seed)
        self.instance_types = inputs.instance_types(records)
        self.provisioner = inputs.provisioner(config["provisioner"])
        self.templates = [inputs.templates(s) for s in self.sets]
        self.indexes = [inputs.index_of(t) for t in self.templates]
        self._made = 0
        self.offers = deque(
            self._offer() for _ in range(
                1 + self.traffic["offers"] + self.traffic["stretch"]))

    def _offer(self) -> tuple:
        from . import inputs

        s, tag = self._made % len(self.sets), str(self._made)
        self._made += 1
        return s, tag, inputs.fresh(self.templates[s], tag)

    def next_offer(self) -> tuple:
        """``(set, tag, pods)`` of the next offer; one copied on the spot
        only where a window outruns the ones set-up made."""
        return self.offers.popleft() if self.offers else self._offer()


def _histograms(reg) -> dict:
    """Every histogram of the program's registry: (sum, count)."""
    return {n: (sum(h.sums.values()), sum(h.totals.values()))
            for n, h in reg.histograms.items()}


def _delta(before: dict, after: dict) -> dict:
    return {n: (v[0] - before.get(n, (0.0, 0))[0],
                v[1] - before.get(n, (0.0, 0))[1])
            for n, v in after.items()}


def _sync(device):
    def sync():
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
    return sync


def _profile(drv, c, ctx, device) -> tuple:
    """The profiled stretch: CUDA activity only, anchored on the two
    device-wide synchronizes around it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        reqs, t_sync, t_end = drv.stretch(c["traffic"]["stretch"],
                                          _sync(device))
    ev = tracing.device_events(prof)
    del prof
    off = tracing.anchor(ev["syncs"], t_sync, t_end)

    def host(ns):
        return (ns - off) / 1e9

    spans = [s for r in reqs for s in r.spans]
    solve_iv = tracing.union(
        (a, b) for nm, a, b, _ in spans
        if nm in ("device_execute", "device_dispatch", "device_fence",
                  "megabatch"))
    starts = [a for a, _ in solve_iv]
    k_in = [k for k in ev["kernels"]
            if tracing.in_any(solve_iv, starts, host(k[3]))]
    busy = tracing.union((host(s), host(e))
                         for s, e, _n, _l in ev["kernels"] + ev["copies"])
    busy_s = tracing.covered(busy, t_sync, t_end)
    totals: dict = {}
    for s, e, name, _l in ev["kernels"] + ev["copies"]:
        totals[name] = totals.get(name, 0.0) + (e - s) / 1e9
    idle: dict = {}
    for a, b in tracing.gaps(busy, t_sync, t_end):
        nm = tracing.innermost(spans, (a + b) / 2)
        idle[nm] = idle.get(nm, 0.0) + (b - a)
    prof_rec = {
        "solves": sum(1 for r in reqs if r.error is None),
        "launches": len(ev["kernels"]),
        "kernel_s_in_solve": sum((e - s) / 1e9 for s, e, _n, _l in k_in),
        "busy_s": busy_s,
        "window_s": t_end - t_sync,
    }
    breakdown = {
        "device_ops": [[n[:120], v] for n, v in
                       sorted(totals.items(), key=lambda t: -t[1])[:10]],
        "idle_gaps": [[n, v] for n, v in
                      sorted(idle.items(), key=lambda t: -t[1])[:10]],
    }
    return reqs, prof_rec, breakdown


def _cpu_and_wall() -> tuple:
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, time.perf_counter()


def _free(drv) -> None:
    drv.close()
    gc.collect()
    try:
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    except ImportError:
        pass


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of cell ``c``; returns the result line's object (the
    compared numbers under ``compared``, last)."""
    import torch

    from . import inputs

    cuda = device.type == "cuda"
    ctx = Context(c, seed, device)
    ctx.kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    drv = driver_class(c["traffic"]["entry"])(ctx)
    drv.warm()
    if cuda:
        torch.cuda.synchronize(device)
    h0 = _histograms(drv.registry)
    setup_s = time.perf_counter() - t_start
    cpu0, wall0 = _cpu_and_wall()
    window, window_s = drv.window(seconds, trace)
    cpu1, wall1 = _cpu_and_wall()
    h1 = _histograms(drv.registry)
    stretch, prof, breakdown = [], None, None
    if trace and cuda:
        stretch, prof, breakdown = _profile(drv, c, ctx, device)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    _free(drv)
    del drv

    # ---- the reference, after the window and the program's state --------
    t_ref = time.perf_counter()
    ffd = {s: reference.ffd(ctx.sets[s], ctx.candidates)
           for s in sorted({r.set for r in window + stretch})}
    faults = dict.fromkeys(reference.FAULT_KINDS + ("failed",), 0)
    for r in window + stretch:
        if r.result is not None:
            r.plan = inputs.plain_plan(r.result, ctx.indexes[r.set], r.tag)
            r.result = None
        if r.error is not None:
            faults["failed"] += 1
            continue
        for k, v in reference.check(ctx.sets[r.set], r.plan,
                                    ctx.candidates).items():
            faults[k] += v
    served = [r for r in window if r.error is None]
    cost_p = sum(reference.plan_cost(r.plan, ctx.candidates) for r in served)
    cost_r = sum(ffd[r.set][0] for r in served)
    if prof is not None:
        prof["least_s"] = sum(
            roofline.least_seconds(*roofline.loop_work(
                ctx.sets[r.set], int(ctx.candidates.price.size),
                len(ctx.candidates.zones), len(ffd[r.set][1])),
                ctx.kind)[0]
            for r in stretch if r.error is None)
    ref_s = time.perf_counter() - t_ref

    run = Run(window=window, window_s=window_s, setup_s=setup_s,
              cost_program=cost_p, cost_reference=cost_r,
              hist_delta=_delta(h0, h1), profile=prof)
    names = c["per_layer"] if trace else c["end_to_end"]
    metrics = {}
    for m in names:
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type, "kind": ctx.kind,
           "count": 1, "memory_peak_bytes": peak}
    if prof is not None:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
    plan_faults = sum(faults.values())
    attempted = len(window) + len(stretch)
    failed = sum(1 for r in window + stretch if r.error is not None)
    walls = [r.t1 - r.t0 for r in sorted(window, key=lambda r: r.t0)
             if r.error is None]
    out = {
        "correct": plan_faults == 0 and bool(walls),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["faults"] = {k: v for k, v in faults.items() if v}
    # the process's cpu seconds per second of the window: how host-bound
    out["process_cpu_per_s"] = (cpu1 - cpu0) / (wall1 - wall0)
    out["reference_s"] = ref_s
    if walls:
        # the window's last five solves over its first five (B7's drift)
        k = min(5, len(walls))
        first, last = sum(walls[:k]) / k, sum(walls[-k:]) / k
        out["drift"] = {"first5_ms": first * 1e3, "last5_ms": last * 1e3,
                        "last5_over_first5": last / first}
    _write_walls(c["name"], seed, trace, window, setup_s, ref_s)
    out["compared"] = {"plan_faults": {"value": plan_faults, "limit": 0}}
    return out


def _write_walls(name: str, seed: int, trace: bool, window: list,
                 setup_s: float, ref_s: float) -> None:
    """Every request's wall in the window, in order of its start, to
    ``chiprun_out/benchmark/<cell>.<seed>.<trace>.json``."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    t0 = min((r.t0 for r in window), default=0.0)
    doc = {"cell": name, "seed": seed, "trace": int(trace),
           "setup_s": setup_s, "reference_s": ref_s,
           "requests": [[round(r.t0 - t0, 6), round(r.t1 - r.t0, 6),
                         r.set, r.pods, r.error]
                        for r in sorted(window, key=lambda r: r.t0)]}
    with open(OUT_DIR / f"{name}.{seed}.{int(trace)}.json", "w") as f:
        json.dump(doc, f)
