"""The config-4 repack driven through the port's controllers.

    python -m karpenter_tpu_torch.repack [--device cuda] [--nodes 300 2000]
        [--reconcile 5000] [--screen 5000] [--profile 300] [--progress]

The reference bench's repack harness (``bench_all._repack_fleet``,
``_repack_env``, ``_repack_to_convergence``, ``_one_reconcile_at``) over
the port: an under-utilised fleet of one 16-cpu type loaded into a
``ClusterState``, the provisioning, termination and deprovisioning
controllers over one ``BatchScheduler``, and

- :func:`repack_to_convergence` — the full deprovisioning ladder
  (propose -> 15 s TTL -> revalidate -> execute -> drain -> rebind) in
  5 s ticks until 12 idle ticks;
- :func:`one_reconcile_at` — one full consolidation evaluation (screen,
  subset confirm, a proposed action executed), the fleet settled, then a
  second, warm evaluation;
- :func:`screen_at` — the evaluation's first step alone: compat rows and
  one screen of every single and structured subset;
- :func:`profile_what_if` — one consolidation what-if, traced.

The command line prints one JSON line per run (walls on the host clock,
the controller's per-phase seconds, the decisions) and writes them to
``chiprun_out/repack.json``; ``chip_smoke.py`` drives the same functions
in its controllers phase.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path

import numpy as np

from .models.instancetype import GIB


def reset_name_counters() -> None:
    """Restart the process-wide name counters (machines, fake instances,
    auto-named nodes): coalescing orders candidates by (size, name), so two
    runs compare equal only from the same counter state."""
    from .cloud import fake
    from .models import machine
    from .solver import types

    machine._machine_counter = itertools.count()
    fake._instance_counter = itertools.count()
    with types._node_lock:
        types._node_next = 0


def repack_fleet(catalog, n_nodes, rng):
    """The config-4 fleet: ~30%-utilised nodes of the catalog's first type
    with at least 15 cpu, 2–5 pods each (cpu uniform 0.25–1.5, memory
    uniform 0.5–2.0 GiB), zones cycling a/b/c (the reference bench's
    ``_repack_fleet``: the same draws in the same order)."""
    from .models import labels as L
    from .models.pod import PodSpec
    from .solver.types import SimNode

    it = next(t for t in catalog if t.allocatable.get("cpu", 0) >= 15)
    specs = []
    for i in range(n_nodes):
        zone = f"zone-1{'abc'[i % 3]}"
        pods = [
            PodSpec(
                name=f"n{i}-p{k}",
                requests={"cpu": float(rng.uniform(0.25, 1.5)),
                          "memory": float(rng.uniform(0.5, 2.0)) * GIB},
                owner_key=f"n{i}",
            )
            for k in range(int(rng.integers(2, 6)))
        ]
        node = SimNode(
            instance_type=it.name, provisioner="default", zone=zone,
            capacity_type="on-demand", price=it.offerings[0].price,
            allocatable=dict(it.allocatable),
            labels={**it.labels(), L.ZONE: zone,
                    L.CAPACITY_TYPE: "on-demand",
                    L.PROVISIONER_NAME: "default"},
            existing=True, name=f"bench-n{i}",
        )
        node.labels[L.HOSTNAME] = node.name
        specs.append((node, pods))
    return specs


def repack_env(catalog, n_nodes, backend, device, deprovisioning_ttl=None):
    """The controllers over the repack fleet loaded into a ``ClusterState``
    (a ``Machine`` per node, initialised), the clock past the minimum node
    lifetime.  ``device=None`` is the CUDA card.  Returns (clock, state,
    deprov, term, prov_ctrl, reg)."""
    from .cloud.fake import FakeCloudProvider
    from .controllers import deprovisioning as deprov_mod
    from .controllers.provisioning import ProvisioningController
    from .controllers.state import ClusterState
    from .controllers.termination import TerminationController
    from .events import Recorder
    from .metrics import Registry
    from .models.machine import Machine
    from .models.provisioner import Provisioner
    from .solver.scheduler import BatchScheduler
    from .utils.clock import FakeClock

    rng = np.random.default_rng(42)
    clock = FakeClock()
    state = ClusterState(clock=clock)
    cloud = FakeCloudProvider(catalog, clock=clock)
    reg = Registry()
    rec = Recorder()
    sched = BatchScheduler(backend=backend, registry=reg, device=device)
    prov_ctrl = ProvisioningController(
        state, cloud, scheduler=sched, recorder=rec, registry=reg,
        clock=clock)
    term = TerminationController(state, cloud, recorder=rec, registry=reg,
                                 clock=clock)
    kw = {}
    if deprovisioning_ttl is not None:
        kw["deprovisioning_ttl"] = deprovisioning_ttl
    deprov = deprov_mod.DeprovisioningController(
        state, cloud, term, provisioning=prov_ctrl, scheduler=sched,
        recorder=rec, registry=reg, clock=clock, **kw)
    state.apply_provisioner(
        Provisioner(name="default", consolidation_enabled=True).with_defaults())
    for i, (node, pods) in enumerate(repack_fleet(catalog, n_nodes, rng)):
        for p in pods:
            state.add_pod(p)
        node.pods = list(pods)
        ns = state.add_node(node, machine=Machine(
            name=f"m{i}", provider_id=f"i-r{i:08d}"))
        ns.initialized = True
    clock.advance(deprov_mod.MIN_NODE_LIFETIME + 1)
    return clock, state, deprov, term, prov_ctrl, reg


def cluster_plan(state) -> list:
    """The cluster as it stands: per node its name, type, zone, capacity
    type and bound pods."""
    return sorted(
        (ns.node.name, ns.node.instance_type, ns.node.zone,
         ns.node.capacity_type, tuple(sorted(p.name for p in ns.node.pods)))
        for ns in state.nodes.values())


def action_key(action) -> tuple:
    """What decides an action: kind, mechanism, nodes, savings to 1e-9."""
    return (action.kind, action.mechanism, tuple(action.nodes),
            round(action.savings, 9))


def cluster_faults(state, cloud=None, unbound_ok=()) -> list:
    """What breaks the cluster's invariants, as messages: a pod bound
    twice, not bound (unless named in ``unbound_ok``), or bound to a node
    that does not exist or does not hold it; a node over its allocatable;
    cloud instances that do not match the nodes one to one.  Empty when
    the cluster is sound."""
    faults = []
    seen: dict = {}
    for ns in state.nodes.values():
        used: dict = {"pods": 0.0}
        for p in ns.node.pods:
            if p.name in seen:
                faults.append(f"pod {p.name} on {seen[p.name]} and "
                              f"{ns.node.name}")
            seen[p.name] = ns.node.name
            used["pods"] += 1.0
            for k, v in p.requests.items():
                used[k] = used.get(k, 0.0) + v
        for k, v in used.items():
            cap = ns.node.allocatable.get(k)
            if cap is not None and v > cap * (1.0 + 1e-9):
                faults.append(f"node {ns.node.name} over its {k}: "
                              f"{v} > {cap}")
    for name in state.pods:
        node = state.bindings.get(name)
        if node is None:
            if name not in unbound_ok:
                faults.append(f"pod {name} is not bound")
        elif node not in state.nodes or seen.get(name) != node:
            faults.append(f"pod {name} is bound to {node}, which does not "
                          "exist or does not hold it")
    if cloud is not None and len(cloud.instances) != len(state.nodes):
        faults.append(f"{len(cloud.instances)} cloud instances for "
                      f"{len(state.nodes)} nodes")
    return faults


def repack_to_convergence(catalog, n_nodes, backend="auto", device=None,
                          on_tick=None):
    """Drive the deprovisioning ladder on the repack fleet in 5 s ticks
    until 12 idle ticks or 800 ticks; ``on_tick(tick, seconds, action)``
    is called after each tick.  Returns the final state, the run's numbers
    and the executed actions' :func:`action_key` s."""
    from .metrics import DEPROVISIONING_DURATION

    clock, state, deprov, term, prov_ctrl, reg = repack_env(
        catalog, n_nodes, backend, device)
    cost0 = sum(ns.node.price for ns in state.nodes.values())
    t0 = time.perf_counter()
    actions, idle_ticks, ticks, other_s = [], 0, 0, 0.0
    while idle_ticks < 12 and ticks < 800:
        t_tick = time.perf_counter()
        act = deprov.reconcile()
        t1 = time.perf_counter()
        term.reconcile()
        prov_ctrl.reconcile()
        other_s += time.perf_counter() - t1
        clock.advance(5.0)
        ticks += 1
        if on_tick is not None:
            on_tick(ticks, time.perf_counter() - t_tick, act)
        if act is not None:
            actions.append(act)
            idle_ticks = 0
        else:
            idle_ticks += 1
    wall_s = time.perf_counter() - t0
    hist = reg.histogram(DEPROVISIONING_DURATION)
    n_obs = sum(hist.totals.values())
    phases = dict(sorted(deprov.phase_s.items(), key=lambda kv: -kv[1]))
    phases["drain_rebind"] = other_s
    return state, dict(
        initial_cost=cost0,
        final_cost=sum(ns.node.price for ns in state.nodes.values()),
        nodes_start=n_nodes, nodes_end=len(state.nodes),
        pods=len(state.pods), actions=len(actions),
        action_nodes=[len(a.nodes) for a in actions],
        action_kinds=[f"{a.kind}/{a.mechanism}" for a in actions],
        ticks=ticks, pending_end=len(state.pending_pods()), wall_s=wall_s,
        reconcile_mean_ms=(sum(hist.sums.values()) / n_obs * 1000.0
                           if n_obs else 0.0),
        phase_s=phases, phase_n=dict(deprov.phase_n),
    ), [action_key(a) for a in actions]


def one_reconcile_at(catalog, n_nodes, device=None, on_first=None):
    """One full consolidation evaluation at ``n_nodes`` (TTL 0: the
    screen, the subset confirm, a proposed action executed), the fleet
    settled (drain and rebind), then a second, warm evaluation.  Returns
    the final state and the run's numbers, with the screen program's runs
    and the hand-written kernels' launches of the first evaluation and the
    settled cluster's :func:`cluster_faults`.  ``on_first(seconds,
    action, phase_s)`` is called after the first evaluation."""
    from . import kernels
    from .solver import consolidation as cons

    clock, state, deprov, term, prov_ctrl, _reg = repack_env(
        catalog, n_nodes, "auto", device, deprovisioning_ttl=0.0)
    cons.SCREEN_PROGRAM.reset()
    kernels.reset_counts()
    t0 = time.perf_counter()
    action = deprov.reconcile()
    first_s = time.perf_counter() - t0
    screen_runs = dict(cons.SCREEN_PROGRAM.runs)
    launches = {k.name: k.launches for k in kernels.ALL}
    phase_first = dict(deprov.phase_s)
    if on_first is not None:
        on_first(first_s, action, phase_first)
    t1 = time.perf_counter()
    settle_ticks = 0
    for _ in range(10):
        term.reconcile()
        prov_ctrl.reconcile()
        clock.advance(5.0)
        settle_ticks += 1
        if not state.pending_pods():
            break
    settle_s = time.perf_counter() - t1
    settled_faults = cluster_faults(state)
    clock.advance(20.0)
    settled = not state.pending_pods()
    t2 = time.perf_counter()
    warm_action = deprov.reconcile()
    warm_s = time.perf_counter() - t2
    return state, dict(
        nodes=n_nodes, pods=len(state.pods), reconcile_s=first_s,
        reconcile_warm_s=warm_s if settled else None,
        settle_s=settle_s, settle_ticks=settle_ticks,
        settled_faults=settled_faults[:5],
        proposed=action.kind if action is not None else None,
        proposed_nodes=len(action.nodes) if action is not None else 0,
        warm_proposed=(warm_action.kind if warm_action is not None
                       else None),
        warm_proposed_nodes=(len(warm_action.nodes)
                             if warm_action is not None else 0),
        phase_s_first=phase_first, phase_s=dict(deprov.phase_s),
        phase_n=dict(deprov.phase_n), screen_program_runs=screen_runs,
        kernel_launches=launches, nodes_after=len(state.nodes))


def screen_at(catalog, n_nodes, device=None) -> dict:
    """The first step of a consolidation evaluation at ``n_nodes``, as
    ``DeprovisioningController._consolidation`` takes it: the candidates
    in disruption order, the compat rows of the candidate sources, the
    structured multi-node subsets, and one screen of every single and
    every subset on the scheduler's device.  Wall seconds of each part,
    the screen program's runs and what the screen found deletable."""
    from .controllers.deprovisioning import SCREEN_PMAX
    from .solver import consolidation as cons

    _clock, state, deprov, _term, _prov, _reg = repack_env(
        catalog, n_nodes, "auto", device, deprovisioning_ttl=0.0)
    cons.SCREEN_PROGRAM.reset()
    t0 = time.perf_counter()
    cands = deprov._candidates()
    all_nodes = state.schedulable_nodes()
    idx_of = {n.name: i for i, n in enumerate(all_nodes)}
    cand_idx = [idx_of[ns.node.name] for _, ns in cands]
    t1 = time.perf_counter()
    compat = cons.compat_matrix(all_nodes, sources=cand_idx)
    t2 = time.perf_counter()
    singles = [[i] for i in cand_idx]
    multis = deprov._multi_subsets(cand_idx, cands, idx_of)
    screen = cons.screen_subset_deletes(
        all_nodes, singles + multis, compat, pmax_total=SCREEN_PMAX,
        device=deprov.scheduler.device)
    t3 = time.perf_counter()
    deletable = screen.deletable
    return dict(nodes=n_nodes, candidates=len(cands), subsets=len(multis),
                candidates_s=t1 - t0, compat_matrix_s=t2 - t1,
                screen_s=t3 - t2, screen_eval_ms=screen.eval_ms,
                screen_program_runs=dict(cons.SCREEN_PROGRAM.runs),
                singles_deletable=int(deletable[:len(singles)].sum()),
                subsets_deletable=int(deletable[len(singles):].sum()))


def profile_what_if(catalog, n_nodes, fraction=0.8, device=None) -> dict:
    """One consolidation what-if of the repack fleet — the pods of the
    first ``fraction`` of the consolidation candidates onto the rest plus
    at most one new node, as the prefix and escalate searches ask it —
    timed twice on the host clock; on the card the second call is traced
    with ``torch.profiler``: kernel launches, summed kernel time, the
    device's busy share of the call and the top kernels by launches."""
    import torch

    _clock, state, deprov, _term, _prov, _reg = repack_env(
        catalog, n_nodes, "auto", device, deprovisioning_ttl=0.0)
    sched = deprov.scheduler
    targets = [ns for _, ns in deprov._candidates()]
    targets = targets[: max(2, int(len(targets) * fraction))]
    pods = [p for ns in targets for p in ns.node.pods if not p.is_daemon]
    provs = [p.with_defaults() for p in state.provisioners.values()]
    st, _ = sched._tensorize(pods, provs, catalog, (), None)
    cuda = sched.device.type == "cuda"

    def call():
        out = deprov._simulate(targets)
        if cuda:
            torch.cuda.synchronize()
        return out

    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        action = call()
        walls.append(time.perf_counter() - t0)
    out = dict(nodes=n_nodes, targets=len(targets), pods=len(pods),
               groups=st.G, candidates=st.C, device=sched.device.type,
               wall_s=walls, action=(None if action is None else
                                     [action.kind, len(action.nodes)]))
    if not cuda:
        return out
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        wall = time.perf_counter() - t0
    kernels: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            continue
        c, t = kernels.get(e.name, (0, 0.0))
        kernels[e.name] = (c + 1, t + (e.time_range.end
                                       - e.time_range.start) / 1000.0)
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for a, b in sorted(spans):  # union of kernel intervals, us
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    launches = sum(c for c, _ in kernels.values())
    syncs = sum(e.count for e in prof.key_averages()
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                             "cudaMemcpyAsync"))
    out.update(
        profiled_wall_s=wall, kernel_launches=launches,
        launches_per_group=launches / max(1, st.G),
        device_kernel_ms=sum(t for _, t in kernels.values()),
        device_busy_share=(busy / 1000.0) / (wall * 1000.0),
        host_syncs_and_copies=syncs,
        top_kernels=[dict(name=k[:70], launches=c, ms=t) for k, (c, t) in
                     sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--nodes", type=int, nargs="*", default=[],
                    help="fleet sizes driven to convergence, in turn")
    ap.add_argument("--reconcile", type=int, nargs="*", default=[],
                    help="fleet sizes of one full reconcile, in turn")
    ap.add_argument("--screen", type=int, nargs="*", default=[],
                    help="fleet sizes of one controller screen step")
    ap.add_argument("--profile", type=int, nargs="*", default=[],
                    help="fleet sizes of one traced what-if, in turn")
    ap.add_argument("--progress", action="store_true",
                    help="also print a line per tick and after the first "
                         "evaluation")
    args = ap.parse_args(argv)

    def on_tick(tick, seconds, action):
        print(json.dumps({"tick": tick, "s": seconds, "action": (
            None if action is None else [action.kind, len(action.nodes)])}),
              flush=True)

    def on_first(seconds, action, phase_s):
        print(json.dumps({"first_s": seconds, "action": (
            None if action is None else [action.kind, len(action.nodes)]),
            "phase_s": phase_s}), flush=True)

    from .models.catalog import generate_catalog

    catalog = generate_catalog(full=True)
    out = []
    for n in args.screen:
        reset_name_counters()
        out.append({"run": "screen", **screen_at(catalog, n, args.device)})
        print(json.dumps(out[-1]), flush=True)
    for n in args.profile:
        reset_name_counters()
        out.append({"run": "profile", **profile_what_if(
            catalog, n, device=args.device)})
        print(json.dumps(out[-1]), flush=True)
    for n in args.reconcile:
        reset_name_counters()
        _state, info = one_reconcile_at(
            catalog, n, args.device,
            on_first=on_first if args.progress else None)
        out.append({"run": "reconcile", **info})
        print(json.dumps(out[-1]), flush=True)
    for n in args.nodes:
        reset_name_counters()
        state, info, _keys = repack_to_convergence(
            catalog, n, "auto", args.device,
            on_tick=on_tick if args.progress else None)
        info["faults"] = cluster_faults(state)[:5]
        out.append({"run": "converge", **info})
        print(json.dumps(out[-1]), flush=True)
    path = Path("chiprun_out")
    path.mkdir(exist_ok=True)
    (path / "repack.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
