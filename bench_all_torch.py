#!/usr/bin/env python3
"""All six BASELINE.json benchmark configs on the PyTorch/CUDA port —
``karpenter_tpu_torch`` on a CUDA device against the port's in-repo CPU FFD
oracle (BASELINE.md "Targets for this repo").

    python3 bench_all_torch.py [--configs 1,3] [--device cuda|cpu]
    karpenter-tpu-torch bench [--configs ...] [--device ...]

The port of ``bench_all.py``.  Prints ONE JSON line PER config:

  {"config": N, "metric": ..., "value": <device ms>, "unit": "ms",
   "vs_baseline": <cpu_ms / device_ms>, "cost_ratio_vs_ffd": ...,
   "device": ..., "gpu": <nvidia-smi name, power limit>, ...}

``bench_torch.py`` stays the single-line headline (config #2).  The device
is the CUDA card unless ``--device cpu`` is given; without a card the
default refuses with an error line.  A config that fails prints a line
with ``"error"`` and the command exits 1 after the sweep.

Config 4 runs each of its long stages (the repack to convergence on the
device and on the oracle, one full reconcile at 5,000 nodes) in a child
process under a deadline (:data:`C4_ATTEMPT_S` a size) at the reference's
size first; a size that does not finish is killed and the next rung of a fixed
ladder runs instead.  The line then carries ``reduced``: one ``{"what",
"from", "to", "why"}`` per stage that was cut, and partial results stream
to stderr as they land.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from bench_torch import arm_watchdog, ensure_device, gpu_line, run_child
from karpenter_tpu_torch.repack import repack_fleet as _repack_fleet

ROOT = Path(__file__).resolve().parent

#: seconds one config-4 stage may run at one size before the next rung
C4_ATTEMPT_S = 200.0
#: the reference's one-reconcile probe size
C4_RECONCILE_NODES = 5000


def _ffd_and_tpu(pods, provs, catalog, label, device=None):
    """Shared harness: CPU oracle once, one device solve (its first
    execution reported as ``compile_ms``, the timed second as ``value``),
    report."""
    from karpenter_tpu_torch.models.tensorize import tensorize
    from karpenter_tpu_torch.solver import reference
    from karpenter_tpu_torch.solver.scheduler import NATIVE_BATCH_LIMIT
    from karpenter_tpu_torch.solver.tpu import solve_tensors

    t0 = time.perf_counter()
    oracle = reference.solve(pods, provs, catalog)
    cpu_ms = (time.perf_counter() - t0) * 1000.0

    # track_assignments=True is the production configuration (per-node
    # group tracking lets hostname-capped solves coalesce)
    st = tensorize(pods, provs, catalog)
    out = solve_tensors(st, track_assignments=True, measure=True,
                        device=device)
    tpu = out.result
    cost_ratio = (
        tpu.new_node_cost / oracle.new_node_cost if oracle.new_node_cost > 0 else 1.0
    )
    # which tier the auto policy serves this batch size from in steady
    # state: small batches are oracle-served, larger ones device-served
    serving = "oracle" if len(pods) <= NATIVE_BATCH_LIMIT else "tpu"
    return {
        "metric": label,
        "value": round(out.solve_ms, 3),
        "unit": "ms",
        "vs_baseline": round(cpu_ms / max(out.solve_ms, 1e-9), 3),
        "cpu_ffd_ms": round(cpu_ms, 1),
        "compile_ms": round(out.compile_ms, 1),
        "cost_ratio_vs_ffd": round(cost_ratio, 4),
        "tpu_nodes": len(tpu.nodes),
        "ffd_nodes": len(oracle.nodes),
        "infeasible": len(tpu.infeasible),
        "infeasible_ffd": len(oracle.infeasible),
        "serving_tier": serving,
        "serving_nodes": len(oracle.nodes) if serving == "oracle" else len(tpu.nodes),
        "serving_cost_ratio": 1.0 if serving == "oracle" else round(cost_ratio, 4),
    }


def config1(device=None):
    """1k uniform-CPU pods, 1 Provisioner, 20 instance types."""
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.models.provisioner import Provisioner

    catalog = generate_catalog(full=False)
    pods = [PodSpec(name=f"p{i}", requests={"cpu": 1.0}, owner_key="u")
            for i in range(1000)]
    provs = [Provisioner(name="default").with_defaults()]
    rec = _ffd_and_tpu(pods, provs, catalog, "c1_1k_uniform_20types", device)

    # cold-tier diagnostic: the native C++ FFD (solver/native.py), the tier
    # that serves a batch while the device is latched unhealthy
    from karpenter_tpu_torch.models.tensorize import tensorize
    from karpenter_tpu_torch.solver import native as native_mod

    if native_mod.available():
        st = tensorize(pods, provs, catalog)
        t0 = time.perf_counter()
        nres = native_mod.solve_tensors_native(st, existing_nodes=[], max_nodes=1000)
        rec["cold_native_ms"] = round((time.perf_counter() - t0) * 1000.0, 3)
        rec["cold_native_nodes"] = len(nres.nodes)
    return rec


def config2(device=None):
    """50k mixed CPU/mem pods, full catalog, 3-AZ spread (bench_torch.py
    headline)."""
    from bench_torch import build_scenario

    pods, provs, catalog = build_scenario()
    return _ffd_and_tpu(pods, provs, catalog, "c2_50k_mixed_full_catalog_3az",
                        device)


def config3(device=None):
    """10k pods with pod anti-affinity + taints/tolerations (hostname spread)."""
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.instancetype import GIB
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodAffinityTerm,
        PodSpec,
        Taint,
        Toleration,
    )
    from karpenter_tpu_torch.models.provisioner import Provisioner

    catalog = generate_catalog(full=True)
    pods = []
    for s in range(100):
        sel = LabelSelector.of({"app": f"svc{s}"})
        tol = ([Toleration(key="dedicated", operator="Equal", value="svc",
                           effect=L.EFFECT_NO_SCHEDULE)] if s % 2 else [])
        for i in range(100):
            pods.append(PodSpec(
                name=f"svc{s}-{i}", labels={"app": f"svc{s}"},
                requests={"cpu": 0.5 + (s % 4) * 0.25, "memory": (1 + s % 3) * GIB},
                affinity_terms=[PodAffinityTerm(sel, L.HOSTNAME, anti=True)],
                tolerations=tol, owner_key=f"svc{s}",
            ))
    provs = [
        Provisioner(name="dedicated", weight=10,
                    taints=[Taint(key="dedicated", effect=L.EFFECT_NO_SCHEDULE,
                                  value="svc")]).with_defaults(),
        Provisioner(name="default", weight=5).with_defaults(),
    ]
    return _ffd_and_tpu(pods, provs, catalog,
                        "c3_10k_antiaffinity_taints_hostname", device)


def _repack_to_convergence(catalog, n_nodes, backend, disable_screen,
                           device=None):
    """Drive the FULL deprovisioning ladder (propose -> 15 s TTL revalidate
    -> execute -> drain -> rebind) on the under-utilised fleet until no
    action fires (``repack.repack_to_convergence``), in the reference
    bench's record.  ``disable_screen`` is the pure-CPU baseline:
    sequential prefix binary search + singles, no device screen."""
    from karpenter_tpu_torch import repack
    from karpenter_tpu_torch.controllers import deprovisioning as deprov_mod

    saved = (deprov_mod.SCREEN_THRESHOLD, deprov_mod.SUBSET_SCREEN_MIN)
    if disable_screen:
        deprov_mod.SCREEN_THRESHOLD = 10**9
        deprov_mod.SUBSET_SCREEN_MIN = 10**9
    try:
        _state, run, _keys = repack.repack_to_convergence(
            catalog, n_nodes, backend=backend, device=device)
    finally:
        deprov_mod.SCREEN_THRESHOLD, deprov_mod.SUBSET_SCREEN_MIN = saved
    phases = {k: round(v, 1) for k, v in
              sorted(run["phase_s"].items(), key=lambda kv: -kv[1])}
    return {
        "initial_cost": round(run["initial_cost"], 2),
        "final_cost": round(run["final_cost"], 2),
        "saved": round(run["initial_cost"] - run["final_cost"], 2),
        "nodes_start": n_nodes,
        "nodes_end": run["nodes_end"],
        "actions": run["actions"],
        "action_nodes": run["action_nodes"][:40],
        "ticks": run["ticks"],
        "pending_end": run["pending_end"],
        "wall_s": round(run["wall_s"], 1),
        "reconcile_mean_ms": round(run["reconcile_mean_ms"], 1),
        "phase_s": phases,
        "phase_calls": run["phase_n"],
    }


def _scratch_pack_ffd(catalog, n_nodes):
    """From-scratch FFD pack of the repack fleet's pods — the reference
    heuristic's answer when allowed to re-bin every pod onto fresh nodes.
    Not a lower bound (FFD is a heuristic)."""
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.solver import reference

    rng = np.random.default_rng(42)
    pods = [p for _node, plist in _repack_fleet(catalog, n_nodes, rng)
            for p in plist]
    provs = [Provisioner(name="default", consolidation_enabled=True).with_defaults()]
    t0 = time.perf_counter()
    res = reference.solve(pods, provs, catalog)
    return {
        "cost": round(res.new_node_cost, 2),
        "nodes": len(res.nodes),
        "infeasible": len(res.infeasible),
        "solve_s": round(time.perf_counter() - t0, 1),
    }


def _one_reconcile_at(catalog, n_nodes, device=None):
    """One full consolidation evaluation (screen + subset confirm +
    propose) at ``n_nodes``, the fleet settled, then a second evaluation
    (``repack.one_reconcile_at``), in the reference bench's record."""
    from karpenter_tpu_torch import repack

    _state, run = repack.one_reconcile_at(catalog, n_nodes, device=device)
    warm = run["reconcile_warm_s"]
    return {
        "n_nodes": n_nodes,
        "reconcile_s": round(run["reconcile_s"], 1),
        # None when pods didn't drain: an unsettled fleet early-outs on the
        # stabilization path and would fake a ~0s steady-state number
        "reconcile_warm_s": round(warm, 1) if warm is not None else None,
        "proposed": run["proposed"],
        "proposed_nodes": run["proposed_nodes"],
    }


def _c4_stage(stage: str, n_nodes: int, device) -> dict:
    """One config-4 stage at one size, as a child process runs it."""
    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=False)
    if stage == "repack":
        return _repack_to_convergence(catalog, n_nodes, "auto", False, device)
    if stage == "oracle":
        return _repack_to_convergence(catalog, n_nodes, "oracle", True, device)
    if stage == "reconcile":
        return _one_reconcile_at(catalog, n_nodes, device)
    raise ValueError(f"unknown config-4 stage {stage!r}")


def _ladder(n: int) -> list:
    """The sizes a stage tries, largest first: the reference's size, then
    1/2, 1/5, 1/10 and 1/20 of it."""
    sizes = []
    for div in (1, 2, 5, 10, 20):
        m = n // div
        if m >= 1 and m not in sizes:
            sizes.append(m)
    return sizes


def _laddered(stage: str, label: str, n: int, device, attempt_s: float,
              reduced: list) -> dict:
    """Run ``stage`` in a child process at ``n`` nodes under ``attempt_s``;
    a size that does not finish is killed and the next rung runs.  Returns
    the first record that finished, with ``reduced`` extended by the cut;
    raises when no rung finishes."""
    missed = []
    for size in _ladder(n):
        cmd = [sys.executable, str(Path(__file__).resolve()),
               "--c4-stage", stage, "--nodes", str(size),
               "--device", str(device)]
        try:
            proc = run_child(cmd, timeout=attempt_s, cwd=str(ROOT))
        except subprocess.TimeoutExpired:  # this size is too large
            missed.append(size)
            print(f"# c4 {label}@{size}: did not finish in {attempt_s:g} s",
                  file=sys.stderr, flush=True)
            continue
        if proc.returncode != 0:
            raise RuntimeError(
                f"config-4 {label} at {size} nodes exited "
                f"{proc.returncode}: {proc.stderr.strip()[-400:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"# c4 {label}@{size}: {json.dumps(rec)}", file=sys.stderr,
              flush=True)
        if missed:
            reduced.append({
                "what": f"{label} nodes", "from": n, "to": size,
                "why": (f"{', '.join(map(str, missed))} node(s) did not "
                        f"finish in {attempt_s:g} s each"),
            })
        return rec
    raise RuntimeError(
        f"config-4 {label}: no size of {_ladder(n)} finished in "
        f"{attempt_s:g} s")


def config4(device=None, attempt_s: float = C4_ATTEMPT_S):
    """Multi-node consolidation screen: 5k under-utilized nodes, then the
    min-cost repack (the BASELINE config-4 product metric) driven to
    convergence on the device and on the oracle, and one full reconcile
    at 5,000 nodes — each long stage under the :func:`_laddered`
    deadline."""
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.instancetype import GIB
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.solver.consolidation import screen_delete_candidates
    from karpenter_tpu_torch.solver.types import SimNode

    catalog = generate_catalog(full=False)
    it = next(t for t in catalog if t.allocatable.get("cpu", 0) >= 15)
    rng = np.random.default_rng(42)
    nodes = []
    for i in range(5000):
        node = SimNode(
            instance_type=it.name, provisioner="default", zone=f"zone-1{'abc'[i % 3]}",
            capacity_type="on-demand", price=it.offerings[0].price,
            allocatable=dict(it.allocatable),
        )
        # ~30% utilization: under-utilized fleet, the consolidation target
        for k in range(int(rng.integers(2, 6))):
            node.pods.append(PodSpec(
                name=f"n{i}-p{k}",
                requests={"cpu": float(rng.uniform(0.25, 1.5)),
                          "memory": float(rng.uniform(0.5, 2.0)) * GIB},
            ))
        nodes.append(node)

    # CPU baseline: the same first-fit screen, sequentially per candidate
    resources = [L.RESOURCE_CPU, L.RESOURCE_MEMORY, L.RESOURCE_PODS]
    residual = np.zeros((len(nodes), 3), dtype=np.float64)
    for i, n in enumerate(nodes):
        rem = n.remaining()
        residual[i] = [max(0.0, rem.get(r, 0.0)) for r in resources]
    t0 = time.perf_counter()
    cpu_deletable = np.zeros(len(nodes), dtype=bool)
    for i, n in enumerate(nodes):
        res = residual.copy()
        res[i] = 0.0
        ok = True
        for p in sorted(n.pods, key=lambda p: -p.requests.get("cpu", 0)):
            row = np.array([p.requests.get(L.RESOURCE_CPU, 0.0),
                            p.requests.get(L.RESOURCE_MEMORY, 0.0), 1.0])
            fits = (res >= row - 1e-9).all(axis=1)
            j = int(np.argmax(fits))
            if not fits[j]:
                ok = False
                break
            res[j] -= row
        cpu_deletable[i] = ok
    cpu_ms = (time.perf_counter() - t0) * 1000.0

    pmax = max(8, max(len(n.pods) for n in nodes))
    out = screen_delete_candidates(nodes, pmax=pmax, measure=True,
                                   device=device)
    agree = float((out.deletable == cpu_deletable).mean())

    # ---- end-to-end min-cost REPACK at KT_C4_REPACK_NODES (default 2k),
    # the oracle-driven pure-CPU loop at KT_C4_ORACLE_NODES (default the
    # device loop's size), one full evaluation at 5k, the from-scratch
    # oracle pack as the achievable-$ yardstick
    # ktlint: allow[KT022] the reference bench's size override, read by this script only
    n_repack = int(os.environ.get("KT_C4_REPACK_NODES", "2000"))
    reduced: list = []
    rec = {
        "metric": "c4_consolidation_screen_5k_nodes",
        "value": round(out.eval_ms, 3),
        "unit": "ms",
        "vs_baseline": round(cpu_ms / max(out.eval_ms, 1e-9), 3),
        "cpu_screen_ms": round(cpu_ms, 1),
        "compile_ms": round(out.compile_ms, 1),
        "deletable": int(out.deletable.sum()),
        "agreement_with_cpu": round(agree, 4),
    }
    if n_repack:
        dev = _laddered("repack", "repack_device", n_repack, device,
                        attempt_s, reduced)
        n_repack = dev["nodes_start"]
        rec["repack_device"] = dev
        rec["repack_scratch_ffd"] = _scratch_pack_ffd(catalog, n_repack)
        # ktlint: allow[KT022] the reference bench's size override, read by this script only
        n_oracle = min(int(os.environ.get("KT_C4_ORACLE_NODES",
                                          str(n_repack))), n_repack)
        orc = _laddered("oracle", "repack_oracle", n_oracle, device,
                        attempt_s, reduced)
        n_oracle = orc["nodes_start"]
        rec["repack_oracle"] = orc
        if n_oracle != n_repack:
            # parity compares like with like: the device loop again at the
            # oracle's scale
            dev_cmp = _laddered("repack", "repack_device_at_oracle_scale",
                                n_oracle, device, attempt_s, reduced)
            rec["repack_device_at_oracle_scale"] = dev_cmp
        else:
            dev_cmp = dev
        if orc.get("saved"):
            rec["repack_savings_parity"] = round(
                dev_cmp["saved"] / orc["saved"], 4)
        rec["repack_speedup"] = round(
            orc["wall_s"] / max(dev_cmp["wall_s"], 1e-9), 2)
        rec["repack_reconcile_5k"] = _laddered(
            "reconcile", "repack_reconcile_5k", C4_RECONCILE_NODES, device,
            attempt_s, reduced)
    rec["reduced"] = reduced
    return rec


def config5(device=None):
    """Spot+on-demand price-aware pack, 10 weighted Provisioners, 5k pods."""
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.instancetype import GIB
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.models.requirements import IN, Requirement

    catalog = generate_catalog(full=True)
    provs = []
    for i in range(10):
        ct = L.CAPACITY_TYPE_SPOT if i % 2 else L.CAPACITY_TYPE_ON_DEMAND
        provs.append(Provisioner(
            name=f"prov-{i}", weight=10 - i,
            requirements=[Requirement(L.CAPACITY_TYPE, IN, [ct])],
        ).with_defaults())
    pods = [PodSpec(name=f"p{i}", requests={"cpu": 0.5 + (i % 5) * 0.5,
                                            "memory": (1 + i % 4) * GIB},
                    owner_key=f"d{i % 8}")
            for i in range(5000)]
    return _ffd_and_tpu(pods, provs, catalog, "c5_spot_od_10weighted_provs_5k",
                        device)


def _interruption_run(catalog, n_msgs: int):
    """``n_msgs`` interruption messages (spot interruptions and state
    changes, half of them for instances outside the cluster) against a
    2,000-node cluster, handled by one ``InterruptionController``
    reconcile on the host.  Returns ``(handled, seconds)``."""
    from karpenter_tpu_torch.cloud.fake import FakeCloudProvider
    from karpenter_tpu_torch.controllers.interruption import (
        SPOT_INTERRUPTION,
        STATE_CHANGE,
        InterruptionController,
        InterruptionMessage,
        MessageQueue,
    )
    from karpenter_tpu_torch.controllers.state import ClusterState
    from karpenter_tpu_torch.controllers.termination import TerminationController
    from karpenter_tpu_torch.events import Recorder
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.models.machine import Machine
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.solver.types import SimNode
    from karpenter_tpu_torch.utils.clock import FakeClock

    it = catalog[0]
    clock = FakeClock()
    state = ClusterState(clock=clock)
    cloud = FakeCloudProvider(catalog, clock=clock)
    reg = Registry()
    term = TerminationController(state, cloud, recorder=Recorder(),
                                 registry=reg, clock=clock)
    state.apply_provisioner(Provisioner(name="default"))
    queue = MessageQueue()
    ic = InterruptionController(state, term, queue, recorder=Recorder(),
                                registry=reg, clock=clock)
    for i in range(2000):
        node = SimNode(instance_type=it.name, provisioner="default",
                       zone="zone-1a", capacity_type="spot", price=0.1,
                       allocatable=dict(it.allocatable), name=f"n{i}")
        machine = Machine(name=f"m{i}", provider_id=f"i-{i:08d}")
        state.add_node(node, machine=machine)
    for i in range(n_msgs):
        kind = SPOT_INTERRUPTION if i % 2 else STATE_CHANGE
        iid = f"i-{i % 4000:08d}"  # half miss the cluster
        queue.send(InterruptionMessage(kind, iid, clock.now(),
                                       state="stopping"))
    t0 = time.perf_counter()
    handled = ic.reconcile()
    return handled, time.perf_counter() - t0


def config6(device=None):
    """Interruption-controller throughput at 100 / 1k / 5k / 15k queued
    messages — the upstream project's own benchmark shape
    (interruption_benchmark_test.go; no numbers published, so measured
    here).  Host-only: ``device`` is not used."""
    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=False)
    rates = {}
    for n_msgs in (100, 1_000, 5_000, 15_000):
        handled, dt = _interruption_run(catalog, n_msgs)
        if handled != n_msgs:
            raise RuntimeError(
                f"interruption controller handled {handled} of {n_msgs} "
                "messages")
        rates[n_msgs] = n_msgs / dt
    return {
        "metric": "c6_interruption_controller_msgs_per_sec",
        "value": round(rates[15_000], 1),
        "unit": "msgs/s",
        "vs_baseline": 1.0,  # the upstream project publishes no numbers
        "rate_100": round(rates[100], 1),
        "rate_1k": round(rates[1_000], 1),
        "rate_5k": round(rates[5_000], 1),
        "rate_15k": round(rates[15_000], 1),
    }


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5,
           6: config6}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", default="1,2,3,4,5,6",
                    help="comma-separated config numbers to run")
    ap.add_argument("--device", default=None,
                    help="torch device (default the CUDA card, refusing to "
                         "run without one; 'cpu' rehearses on the host)")
    # one config-4 stage at one size, run as a child by _laddered
    ap.add_argument("--c4-stage", choices=("repack", "oracle", "reconcile"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--nodes", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.c4_stage:
        print(json.dumps(_c4_stage(args.c4_stage, args.nodes,
                                   ensure_device(args.device))), flush=True)
        return 0

    picked = [int(x) for x in args.configs.split(",") if x.strip()]
    wd = arm_watchdog(float(os.environ.get("BENCH_DEADLINE_S", "3000")),
                      metric="bench_all_sweep")
    rc = 0
    try:
        dev = ensure_device(args.device)
        gpu = gpu_line(dev)
    except Exception as e:  # ktlint: allow[KT005] reported as the sweep's error line
        with wd.lock:
            wd.main_done.set()
            print(json.dumps({
                "metric": "bench_all_sweep", "value": None, "unit": "ms",
                "vs_baseline": None,
                "error": f"{type(e).__name__}: {e}"[:500]}), flush=True)
        return 1
    for n in picked:
        try:
            rec = CONFIGS[n](dev)
        except Exception as e:  # ktlint: allow[KT005] reported as the config's error line; the sweep exits 1
            rc = 1
            rec = {"metric": f"c{n}", "value": None, "unit": "ms",
                   "vs_baseline": None, "error": f"{type(e).__name__}: {e}"[:500]}
        rec = {"config": n, **rec, "device": dev.type, "gpu": gpu}
        with wd.lock:
            print(json.dumps(rec), flush=True)
    wd.cancel()
    with wd.lock:
        wd.main_done.set()
    return rc


if __name__ == "__main__":
    sys.exit(main())
