#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``karpenter_tpu_torch``) on one NVIDIA GPU and
check it end to end.  Run from the repository root: ``python3 chip_smoke.py``.

Phases, each printing one JSON line (any failure exits non-zero and prints
no result):

1. device — ``nvidia-smi`` name and power limit, torch/CUDA versions;
2. build — every kernel compiled from ``karpenter_tpu_torch/csrc`` with
   nvcc for ``sm_90a`` (one nvcc per source, started together);
3. kernel — both entries of the packed-score kernel (``packed_scan_scores``
   on a bf16 price row, ``price_step_scores`` fused with the price math)
   against their plain PyTorch versions on the card and on the host,
   byte-equal, on every case of :func:`step_cases` (ties, all-infeasible
   rows, sentinel and +inf prices, 1 and 3 provisioners, duals up to the
   8.0 cap, a hot provisioner that moves the argmin, tile / slice / large
   shapes up to 65,536 x 1,024); both zone fills (``csrc/zone_fill.cu``:
   ``skew_band_fill``, ``water_fill``) against their plain compositions on
   the card, equal on every row of :func:`fill_cases` (over 100,000 rows,
   Z in 1, 2, 3, 4 and 6);
4. slice — the main path: ``BatchScheduler(backend="auto").solve`` of a
   100,000-pod scale-up (40 zone-spread deployments x 2,500 pods against
   the full catalog) under a provisioner ``limits.cpu`` at 99% of the
   unconstrained buy.  It must route hierarchically, run price iterations
   that launch the fused entry once each (and the price-row entry never),
   keep the shipped cpu within the limit and leave every pod seated or
   typed infeasible.  Launch counts are zeroed just before this run and
   read just after;
5. timing — each entry, its plain version and, where one exists, a
   one-call PyTorch yardstick at the main path's inputs (CUDA graph +
   events), beside the bound; the price-row entry also at 4,096 x 1,024
   and at 65,536 x 1,024 (two buffers in turn, beyond L2); the price
   loop's score step as the host pays it, fused and through the host
   price chain with the price-row entry; both zone fills and their plain
   compositions at the burst's shape (1 row, Z = 3) and the megabatch's
   (32 rows, Z = 3);
6. parity — a smaller hierarchical batch with a binding limit solved on
   ``cuda`` and on ``cpu``: the node plans must agree; then the reference
   (a ``reference`` line): :data:`LATER_HIER`'s batch, 10 of the slice's
   deployments at 2,500 pods each (25,000 pods, routed hierarchically by
   :func:`hier_at`), solved on the card under a cpu limit at its
   unconstrained buy.  Phases 9(a), 10(b), 11(a), 12(c), 14(a) and 15(c)
   drive their paths with that batch, cut from the slice's 40 deployments
   to fit the time limit, and are held to this plan and limit (the record
   keys still say ``slice``).  13(a) keeps the slice's batch: it holds the
   operator's launched nodes to the plan's $/hr, and on this batch the
   plan prices the price loop's re-solved nodes at their dual-adjusted
   prices (ROADMAP C11);
7. relax — the relax rung on the flat path: 50,000 pods in 20
   complementary unconstrained deployments, and a 5,000-pod batch whose
   first 10 deployments carry a zone spread, each solved on ``cuda`` with
   ``relax=False`` (the scan) and at the default (the rung).  The shipped
   plan must cost no more than the scan's, seat every pod exactly once,
   hold node capacity and provisioner limits, count no ``fallback``, run
   the relax program on the card, and equal the ``device="cpu"`` solve;
   the program is also timed alone on the 50,000-pod inputs;
8. consolidation — the deletability screen of a 5,000-node fleet on
   ``cuda`` and on ``cpu`` (equal vectors), and a 16-candidate what-if
   sweep over a 300-node cluster, batched in one dispatch, against the
   serial loop of what-if solves (equal decisions);
9. controllers — (a) the reference's batch provisioned through
   ``ProvisioningController`` (pods added to a ``ClusterState`` under the
   reference's provisioner, the batching window passed, machines created on
   the fake cloud, pods bound): hierarchical routing, one
   ``price_step_scores`` launch per price iteration, the reference's plan
   (equal or ``placements_tie``), every pod bound to a node that exists,
   the limit held; (b) on the config-4 repack fleet: the consolidation
   evaluation's screen step at 5,000 nodes (compat rows, one screen of
   every single and structured subset on the card), one full
   deprovisioning reconcile at 50 nodes (the screen on the card, a
   proposed action executed, the fleet settled, a warm reconcile), and
   the ladder driven to convergence at 20 nodes (no pod pending, every
   pod bound once, no node over its allocatable, a lower cost); (c) a
   20-node fleet driven to convergence on ``cuda`` (that is (b)'s run)
   and on ``cpu``: equal actions, final cluster and bindings.  The sizes are cut from the
   reference bench's 5,000 and 2,000 nodes to fit the time
   (:data:`REPACK_SIZES`);
10. serving — (a) the reference bench's 32 serving requests (320 pods in 8
    zone-spread groups each, small catalog) through
    ``BatchScheduler(backend="auto").submit_many`` in flushes of 1, 8 and
    32 against the first 4 solved one by one (the serial baseline): every
    flushed plan of those equal to its solo plan node for node, the
    32-flush on ``cpu`` equal or ``placements_tie``, ``MEGABATCH_SLOTS`` at 1, 8 and
    32, no cold fallback; an 8-flush's launches and host syncs (enqueue
    and read-back); (b) the reference's batch under the reference's
    limit in one flush beside 7 serving requests: hierarchical routing,
    one ``price_step_scores`` launch per price iteration, the reference's
    plan, the serving plans equal to their solo plans; (c) the bench's
    ``measure_warmstart`` chain (20,000 unconstrained pods, 40 steps of 8
    removals and 8 adds through ``TpuSolver.solve_delta``): step p50/p99,
    modes, fallbacks, the final cost within 1.02 of a fresh solve; (d) 5
    ``BatchScheduler.solve_delta`` steps on the device backend from the
    same base, each adding one zone-spread deployment (the scan tier), on
    ``cuda`` and on ``cpu``: the same modes and final cluster;
11. gangs and resilience — (a) ``gang-hier-100k``: the reference's
    25,000 pods (cut from the slice's 100,000) plus 32 gangs of 16
    members (1 cpu, 0.5 GiB), one gang doomed by
    a member pinned to ``zone-none`` and one short roster (12 of 16),
    solved like the slice (limit at 99% of this batch's own buy):
    hierarchical routing, one ``price_step_scores`` launch per price
    iteration, the limit held, every gang all or none with the typed
    reason, both doomed gangs retracted; (b) ``bench_torch.measure_gang``
    on ``cuda`` (atomicity in 4 variants, co-location packing against
    ``KT_GANG=0``, the gang-free latency ratio over 1 pair), and a
    gang-bearing hierarchical batch on ``cuda`` and ``cpu`` (equal plans);
    (c) ``device_hang@fence`` injected into a fresh ``auto`` scheduler
    (the batch served by a host tier, one hang counted, the probe
    recovering the card, which then answers as an unfaulted scheduler
    does), and a real 5 s stall of the card under a 2 s guard (a hang
    raised, the tier latched, healthy again only after the stall drained);
    (d) the native tier's ``g++`` build, ``backend="native"`` and the
    ``auto`` backend through ``ProvisioningController``;
12. service — the solver sidecar: (a) the reference bench's
    ``measure_throughput`` through ``SolvePipeline`` on ``backend="tpu"``
    (32 clients of 320 pods, 1 s at concurrency 1 on a 1-slot pipeline,
    then 1, 8 and 32 on an 8-slot one): solves/s, slot occupancy, the
    lone-request latency ratio, the device busy share by CUDA events,
    every tenant's plan equal to 10(a)'s, c32 above c1; (b) the
    bench's ``measure_overload``: 2 ``critical`` and 8 ``best_effort``
    closed-loop clients of 200 pods against a tight admission queue, with
    its unloaded critical baseline: no critical shed, some best_effort
    sheds; (c) the reference's batch as one ``Solve`` RPC to
    ``make_server(SolverService(...))`` on a unix socket from a raw
    ``grpc`` stub: encode ms, bytes, RPC wall, ``solve_ms``, the
    reference's plan, one ``price_step_scores`` launch per price iteration; (d)
    ``device_hang@fence`` through a pipeline with admission on: the
    breaker opens, host-routes, half-opens and closes, then the
    ``hier_threshold`` knob moved at runtime routes a 25,000-pod batch
    hierarchically;
13. operator — the deployed topology: (a) the slice's 100,000 pods under
    the slice's limit added to the ``ClusterState`` of the port's
    ``Operator`` (fake cloud, full catalog, ``FakeClock``) whose
    ``RemoteScheduler`` dials a ``SolverService`` over
    ``BatchScheduler(backend="tpu")`` on the card through a unix socket,
    ticked until no pod is pending: tick walls, the RPC beside the
    sidecar's ``solve_ms``, the slice's node multiset and $/hr, every pod
    bound, the limit held, one ``price_step_scores`` launch per price
    iteration, 0 remote fallback solves and a clear degraded gauge; the
    sidecar's ``/metrics``, ``/statusz``, ``/tracez`` and ``/sloz``
    answering, and the operator's ``/fleetz`` merging the sidecar; (b)
    ``cli serve --backend tpu --obs-port`` as a subprocess on the card,
    ``cli demo --pods 200 --backend tpu --solver-address`` against it with
    ``CUDA_VISIBLE_DEVICES=""`` and the same demo in-process on the card:
    equal scale-up lines, both scale-downs with ``pending=0`` and savings,
    no remote fallback, both exit 0, the sidecar draining on SIGTERM; (c)
    the reference bench's ``measure_delta_serving`` (20,000 pods, 40
    steps of 8 removals and 8 adds) through the port's ``DeltaSession``
    and ``SolverService`` over ``backend="tpu"`` on a unix socket: step
    p50/p99, the client's view equal to the server's chain, the chain's
    cost within 1.02 of a fresh full-solve RPC, no fallback or session
    loss;
14. mesh — the device mesh and multi-process execution: (a) a
    ``torch.distributed`` job of world size 1 on nccl, ``make_mesh()``
    over the card (shape (1, 1)) and the reference's limited batch
    through ``BatchScheduler(backend="auto", mesh=mesh)`` from the
    reference's node-name counter: hierarchical routing, every block wave
    one slot-sharded dispatch, no ``mesh_serial`` flush, one
    ``price_step_scores`` launch per price iteration, the reference's plan
    node for node, the limit held; its wall beside the reference's; (b)
    eight virtual shards on the card (``make_mesh(devices=["cuda:0"] * 8)``, shape
    (4, 2)) against the unmeshed path on ``cuda``: the sharded single
    solve of the 64-pod toy scenario and of the 10,000-pod bench scenario
    (NR >= 2048, C >= 512; equal node multisets and costs), 8 serving
    requests in one sharded flush, one block on the card (every plan
    equal to its solo plan), the 16-candidate sweep of phase 8 (equal
    decisions, one dispatch); (c) two ranks sharing the card over gloo,
    four mesh entries each (``scripts/dryrun_multihost_torch.py``, the
    bench's ``measure_multihost_fence`` layout): the host-major layout on the
    real ranks, an 8-slot megabatch served SPMD with each rank reading
    exactly half the fence bytes, foreign slots typed ``SlotNotOwned``
    with their owner, owned plans equal to serial solves, and one foreign
    slot forwarded by ``ResultForwarder`` over gRPC to the owner's
    ``SolverService`` (``KT_MULTIHOST_PEERS``) with the owner's plan;
15. analysis — the port's analysis package: (a) ``python -m
    karpenter_tpu_torch.analysis --format json`` and ``--lock-order`` as
    subprocesses over the checkout: exit 0, 0 findings, the files and
    suppressions counted, the KT012 lock order; (b) ``--model``: the
    delta-epoch, lease-failover and automaton-simulation models explored
    exhaustively, all ok, states / transitions / ms each; (c) the lock
    sanitizer installed (``sanitize.install()``): 12(a)'s closed-loop
    set-up at 8 and 32 clients (every tenant's plan equal to its solo
    plan), then the reference's limited batch as one ``Solve`` RPC through
    ``make_server`` over an ``auto`` scheduler from the reference's
    node-name counter while 8 gRPC clients keep sending: 0
    ``SanitizerError``, 0 ``sanitizer_error`` flight dumps, every observed
    lock nesting in ``LOCK_ORDER``'s order, the reference's plan node for
    node, one
    ``price_step_scores`` launch per price iteration, the clients' plans
    equal to 10(a)'s; then ``uninstall()``; (d) under the port's
    transition tap (``obs.protocol.recording()``), 13(c)'s wire delta
    chain and a second session closed and re-established: every session's
    event sequence a path of the model-checked automaton
    (``conformance.check_events``);
16. bench — the port's benchmark entry points: (a) ``python -m
    karpenter_tpu_torch.cli bench --configs 2,6`` as a subprocess (the
    repo root's ``bench_all_torch.py`` on the card): every line parses,
    carries no ``error``, names the card in ``gpu``; config 2 (the
    50,000-pod headline) leaves no pod infeasible; (b) in process, the
    headline's tensorize tiers (``bench_torch.measure_tensorize``: cached
    tensors equal to a from-scratch build) and
    ``bench_torch.measure_hierarchical`` on the card (the overlap and
    block-disjoint ladders, the packed-score kernel against its plain
    version, the scale model from this run's own per-pod wave rate):
    ``tensorize_parity``, ``hier_pallas_parity`` and
    ``hier_disjoint_parity`` true; the budget flags the reference's
    ``check_budgets`` raises on these records are printed, not failed on;
    (c) in process, at the bench's sizes, the four ``bench_torch`` probes
    whose paths no earlier phase drives: ``measure_warm_coldstart`` (a
    fresh process's first 320-pod serving solve on the card with and
    without the bucket warm; both children exit 0 and the warmed one is
    not served cold), ``measure_multihost_fence`` (14(c)'s two-rank
    verdict, not run again, then the lone-request per-host-fence A/B over
    8 virtual shards in a fresh process; ``multihost_parity`` true, the
    fence fraction and the A/B ratio printed), ``measure_replay_fidelity``
    (a seeded bursty capture replayed through an oracle replica over gRPC;
    no replay error, the class mix intact) and ``measure_tuning`` (the
    static / learn / judged replays of three captures, one pair; no
    replay error);
    no price-loop kernel launches there, in process or in the child
    processes (each prints its own counts, zeroed before its work: the
    warm cold start processes, 14(c)'s ranks, the A/B runs); the budget
    flags are printed, not failed on, and a probe that raises fails the
    run;
17. resilience — ``scripts/chaos_drive_torch.py`` on the card
    (``backend="tpu"``): (a) ``run_chaos`` at 12 of its 60 steps and its
    1,500 pods: the composed 8-kind ``KT_FAULTS`` schedule against a
    fault-free mirror, the four invariants (no silent divergence, mirror
    parity as a node partition, typed errors only, bounded recovery)
    asserted at every step, the faults injected by rule, re-establishes
    and parity-checked steps printed; (b) ``run_restart(snapshot=True)``
    at 500 pods over 4 clients: the sidecar subprocess on the card SIGTERM'd mid-chain and relaunched
    on the card, 0 re-establishes, the restart wall, the relaunch's wait
    for health and the first post-restart delta times; (c)
    ``run_fleet(mode="kill")``: three replicas and the mirror on the card,
    one hard-killed, at least one orphaned session, 0 re-establishes,
    steal adoptions >= orphans, the typed errors and one dead-endpoint
    warning per orphaned client.  Each prints the thread count at its
    start and end; no price-loop kernel launches, in process or in
    either sidecar (each prints its counts at shutdown);
18. fuzz — ``scripts/fuzz_sweep_torch.py``'s runners on the card at cut
    depth (:data:`FUZZ`): (a) the plain, existing-node and kubelet
    suites, 6 seeds each, every seed solved on ``cuda`` and on ``cpu``
    from one counter state (existing nodes named from 0, solves from
    1000): equal plans or ``placements_tie``, the validator, the floor
    and the per-seed ceiling against the port's oracle; per suite n,
    mean, worst and the cuda solve wall p50 and max; (b) ``--delta``, 2
    seeds x 4 steps, drawn on the card and replayed on the host from the
    same inputs and counters: the same mode and plan at every step and
    the same from-scratch re-solves; (c) ``--delta-wire``, 1 seed x 4
    steps, likewise, over a real gRPC session; (d) ``--relax``,
    ``--hier`` and ``--gang``, 2 seeds each: no problem on the card;
    (e) one battle seed at 30 steps on ``backend="tpu"`` under the
    installed lock sanitizer (uninstalled afterwards): every invariant
    after every step, every node reaped, 0 ``SanitizerError``.  No fuzz
    batch reaches the hierarchical threshold, so the phase launches no
    price-loop kernel;
19. tools — the repo-level tools on the card, at depth :data:`TOOLS`:
    (a) ``scripts/profile_solve_torch.py``'s measured solve of config 2
    (50,000 pods, ``BatchScheduler(backend="auto")``; tensorize tiers, the
    process's first solve, 1 repeat, one solve under ``torch.profiler``:
    top kernels, launches, device ms and busy share, the stage table) and
    the host-clock stage table of the hierarchical demo's contended batch
    (8 x 1,250 pods under a cpu limit at 99% of the free buy, the whole
    solve routed hierarchically): the named stages cover at least 90% of
    each solve's wall (config 2's unprofiled and profiled), and every
    price iteration launches ``price_step_scores`` once; (b)
    ``scripts/hier_demo_torch.py``: its
    lines, its contended solve's plan equal to the same batch solved on
    ``cpu`` from the same node-name counter, one ``price_step_scores``
    launch per price iteration; its 1M model's 250 ms verdict is printed
    as a flag, not failed on; (c) ``scripts/slo_demo_torch.py`` on
    ``backend="tpu"``: best_effort sheds and burns, critical's
    availability does not breach, critical's latency verdict printed
    beside its p99 and the 250 ms objective; (d)
    ``scripts/fleet_trace_demo_torch.py``: three replicas on the card, the
    session's home hard-killed, one journey of at least 3 hops over at
    least 2 replicas, every later hop's ``parent_hop`` 0.  A ``guard``
    line follows each of (a)–(d).  ``scripts/tune_demo_torch.py`` is not
    run here: 16(c)'s ``measure_tuning`` drives the same replicas.

After every phase but 11(c) and 12(d) the run checks that no device hang
was counted, no solve was served degraded or host-routed by admission,
every scheduler's guard is healthy and no warning was trapped, and prints
its guarded device calls' longest wall against its budget (a ``guard``
line).  Launch counts (the
hand-written kernels', and the relax and screen programs' runs) are
zeroed just before each path is driven and read just after; no
price-loop kernel (:data:`PRICE_LOOP`) is on the relax, consolidation,
repack, serving-request or delta path or 16(c)'s, 17's or 18's, so
their counts read 0 there, while the zone fills launch on every zoned
group step on the card (the
kernel table adds phase 10(b)'s, 11(a)'s, 12(c)'s, 13(a)'s, 14(a)'s,
15(c)'s, 16(b)'s and 19's launches to the slice's; 16(b)'s one
``packed_scan_scores`` launch is the bench's own kernel-parity check).
The last two lines are the kernel table (``{"kernels": [...]}``) and
``{"ok": true, "device": {...}}``; the ``nvidia-smi`` line precedes them.
Everything is also written to ``chiprun_out/chip_smoke.json``, with the
run's wall seconds (``wall_s``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import signal
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# torch.profiler (the launch counts and busy shares below) leaves CUPTI
# attached after a session unless told to tear it down, and every later
# kernel launch of this launch-bound port then pays for it; the phases
# after the first session ran slower for it
# (``scripts/hier_cost_probe_torch.py``, PERF.md section 6)
os.environ.setdefault("TEARDOWN_CUPTI", "1")

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
#: non-tensor-core float32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

GIB = 1024.0 ** 3
ZONE = "topology.kubernetes.io/zone"

RECORD: dict = {}


class SmokeFailure(Exception):
    pass


class _Faults(logging.Handler):
    """Collects the warnings the port logs where it catches a failure and
    falls back (the relax rung shipping the scan after an exception, a
    sweep dispatch served serially): a device fault must not pass as a
    fallback."""

    def __init__(self) -> None:
        super().__init__(level=logging.WARNING)
        self.records: list = []

    def emit(self, record) -> None:
        self.records.append(f"{record.name}: {record.getMessage()}")


FAULTS = _Faults()


def emit(phase: str, **fields) -> None:
    RECORD[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# scenario
# ---------------------------------------------------------------------------


def deployments(nd: int, per: int, tag: str = "h"):
    """``nd`` deployments of ``per`` pods, each zone-spread (maxSkew 1,
    DoNotSchedule) against its own app selector — one coupling component
    per deployment (the shape of the reference bench's hierarchical
    scenario)."""
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodSpec,
        TopologySpreadConstraint,
    )

    pods = []
    for d in range(nd):
        sel = LabelSelector.of({"app": f"{tag}{d}"})
        for i in range(per):
            pods.append(PodSpec(
                name=f"{tag}{d}-{i}", labels={"app": f"{tag}{d}"},
                requests={"cpu": 0.25 * (1 + d % 8),
                          "memory": (0.5 + (d % 6)) * GIB},
                topology_spread=[TopologySpreadConstraint(
                    1, ZONE, "DoNotSchedule", sel)],
                owner_key=f"{tag}{d}"))
    return pods


#: the batch that the later paths' hierarchical solves take (phases 9(a),
#: 10(b), 11(a), 12(c), 14(a) and 15(c)): 10 of the slice's 40
#: deployments at its 2,500 pods each, routed hierarchically through
#: :func:`hier_at`.  A block wave's time follows the deployments far more
#: than the pods (``scripts/hier_cost_probe_torch.py``, PERF.md section
#: 4), so the cut from 40 deployments is what brings the script inside its
#: time limit; the slice keeps the whole 100,000.  Its cpu limit is
#: the unconstrained buy itself (the slice's is 99% of it): the blocks
#: still contend for it through every price iteration, and no pod is left
#: infeasible, as none is in the slice, so 14(a) still binds and seats
#: every pod.  13(a) keeps the slice's batch (ROADMAP C11)
LATER_HIER = (10, 2500)
LATER_HIER_LIMIT = 1.0


@contextlib.contextmanager
def hier_at(n_pods: int):
    """Route batches of ``n_pods`` pods and more hierarchically while the
    block runs (``KT_HIER_THRESHOLD``, read at each solve)."""
    old = os.environ.get("KT_HIER_THRESHOLD")
    os.environ["KT_HIER_THRESHOLD"] = str(n_pods)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("KT_HIER_THRESHOLD", None)
        else:
            os.environ["KT_HIER_THRESHOLD"] = old


def provisioner(cpu_limit=None):
    from karpenter_tpu_torch.models.provisioner import Provisioner

    p = Provisioner(name="default").with_defaults()
    if cpu_limit is not None:
        p.limits = {"cpu": cpu_limit}
    return p


def cpu_bought(st, nodes) -> float:
    return sum(float(st.capacity_row(n.instance_type, n.allocatable)[0])
               for n in nodes)


def plan(result):
    return sorted(
        (n.instance_type, n.zone, n.capacity_type, round(n.price, 6),
         tuple(sorted(p.name for p in n.pods)))
        for n in result.nodes)


def placements_tie(a, b) -> bool:
    return (set(a.assignments) == set(b.assignments)
            and set(a.infeasible) == set(b.infeasible)
            and np.float32(sum(n.price for n in a.nodes)).tobytes()
            == np.float32(sum(n.price for n in b.nodes)).tobytes())


def limited_solve(device, pods, catalog, frac: float = 0.99):
    """Unconstrained solve, then the solve under a cpu limit at ``frac``
    (99%) of what it bought.  Returns (scheduler, tensors, limit, free,
    limited, stats, limited-solve wall ms, launches per kernel in the
    limited solve)."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics import (
        GANG_DURATION,
        GANG_GANGS,
        HIER_SOLVES,
        RELAX_DURATION,
    )
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    sched = BatchScheduler(backend="auto", device=device)
    free = sched.solve(pods, [provisioner()], catalog)
    check(bool(sched.hier_stats), "unconstrained solve did not route "
          "hierarchically")
    st, _ = sched._tensorize(pods, [provisioner()], catalog, (), None)
    limit = round(cpu_bought(st, free.nodes) * frac, 1)

    hier_before = sched.registry.counter(HIER_SOLVES).get(
        {"path": "hierarchical"})
    relax_before = _outcomes(sched.registry)
    relax_s0 = _hist_sum(sched.registry, RELAX_DURATION)
    gang_s0 = _hist_sum(sched.registry, GANG_DURATION)
    gangs0 = dict(sched.registry.counter(GANG_GANGS).values)
    from karpenter_tpu_torch.solver import types

    # the name counter the limited solve starts from: a rerun from the
    # same state (phase 14(a)) can be held to this plan node for node
    names_at = types._node_next
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = sched.solve(pods, [provisioner(limit)], catalog)
    if sched.device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1000.0
    launches = {k.name: k.launches for k in kernels.ALL}
    check(sched.registry.counter(HIER_SOLVES).get({"path": "hierarchical"})
          == hier_before + 1, "limited solve did not route hierarchically")
    stats = dict(sched.hier_stats)
    stats["names_at"] = names_at
    # every deployment carries a zone spread: the relax rung has nothing
    # to lift and counts one skip (its partition pass is relax_ms)
    stats["relax_outcomes"] = {o: v - relax_before[o] for o, v in
                               _outcomes(sched.registry).items()}
    stats["relax_ms"] = (_hist_sum(sched.registry, RELAX_DURATION)
                         - relax_s0) * 1000.0
    # the gang epilogue of the limited solve (0 ms and no outcome for a
    # gang-free batch)
    stats["gang_ms"] = (_hist_sum(sched.registry, GANG_DURATION)
                        - gang_s0) * 1000.0
    stats["gang_outcomes"] = {
        dict(k)["outcome"]: v - gangs0.get(k, 0.0) for k, v in
        sched.registry.counter(GANG_GANGS).values.items()}
    check(stats["relax_outcomes"]["skipped"] == 1
          and sum(stats["relax_outcomes"].values()) == 1,
          "the limited solve's relax rung did not skip")
    check(stats.get("price_iters", 0) >= 1, "no price iteration ran")
    shipped = cpu_bought(st, res.nodes)
    check(shipped <= limit * (1.0 + 1e-6),
          f"shipped cpu {shipped} exceeds the limit {limit}")
    names = {p.name for p in pods}
    check(set(res.assignments) | set(res.infeasible) == names,
          "a pod is neither seated nor typed infeasible")
    check(all(np.isfinite(n.price) and n.price > 0 for n in res.nodes),
          "a node has a non-finite price")
    return sched, st, limit, free, res, stats, wall_ms, launches, shipped


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)))
    return line


def phase_build():
    from karpenter_tpu_torch import kernels

    t0 = time.perf_counter()
    per = kernels.build(kernels.ALL)
    emit("build", seconds=time.perf_counter() - t0, per_kernel_s=per,
         flags=list(kernels.NVCC_FLAGS),
         entries=[k.name for k in kernels.ALL],
         sources=[lib.repo_path for lib in kernels.libraries()],
         libraries=[lib.library_path().name for lib in kernels.libraries()])


def _score_case(G, C, seed, p=0.6, ties=True):
    """A price-row case as a price-step case: one domain, one provisioner,
    zero duals (so the adjusted row is the price row)."""
    rng = np.random.default_rng(seed)
    feas = rng.random((G, C)) < p
    price = rng.uniform(0.1, 9.0, size=C).astype(np.float32)
    if ties:
        price[C // 2:] = price[: C - C // 2]
    return feas, price[:, None], np.zeros(C, dtype=np.int32), np.zeros(1)


def step_case(G, C, D, P, lam_kind, seed):
    """Feasibility, base prices ``[C, D]``, owners and duals from one numpy
    seed.  Row 0 of f is all-infeasible; candidate 1 is priced at the
    3.0e38 sentinel in every domain, candidate 2 at +inf; about a fifth of
    the other cells have no offering (+inf); the second half of the
    candidates repeats the first half's prices (ties)."""
    rng = np.random.default_rng(seed)
    feas = rng.random((G, C)) < 0.4
    feas[0] = False
    base = rng.uniform(0.05, 12.0, size=(C, D)).astype(np.float32)
    base[C // 2:] = base[: C - C // 2]
    base[rng.random((C, D)) < 0.2] = np.inf
    base[1] = np.float32(3.0e38)
    base[2] = np.inf
    prov = rng.integers(0, P, size=C).astype(np.int32)
    lam = {"zero": np.zeros(P), "mid": rng.uniform(0.05, 1.5, size=P),
           "cap": np.full(P, 8.0)}[lam_kind]
    return feas, base, prov, lam


def step_cases(large: bool = False) -> dict:
    """Every kernel case: ``name -> (feas, base [C, D], prov [C], lam [P])``.
    The price-row entry takes the host chain's row of the same inputs."""
    cases = {}
    for name, (G, C, D) in (("slice_40x425_d6", (40, 425, 6)),
                            ("small_5x7_d2", (5, 7, 2))):
        for P in (1, 3):
            for lam_kind in ("zero", "mid", "cap"):
                cases[f"{name}_p{P}_{lam_kind}"] = step_case(
                    G, C, D, P, lam_kind, seed=G + C + P)
    cases["sentinel_inf_only_row"] = (
        np.array([[0, 1, 1, 0], [1, 1, 1, 1]], dtype=bool),
        np.array([[2.0], [3.0e38], [np.inf], [2.0]], dtype=np.float32),
        np.zeros(4, dtype=np.int32), np.array([0.3]))
    for lam0 in (0.0, 0.6):  # provisioner 0 hot enough to lose the argmin
        cases[f"hot_flip_lam{lam0}"] = (
            np.ones((3, 2), dtype=bool),
            np.array([[1.0, 1.25], [1.5, 1.75]], dtype=np.float32),
            np.array([0, 1], dtype=np.int32), np.array([lam0, 0.0]))
    cases["ties_5x7"] = _score_case(5, 7, 3)
    cases["tile_32x128"] = _score_case(32, 128, 9)
    cases["slice_40x425"] = _score_case(40, 425, 5, p=0.3)
    cases["large_4096x1024"] = _score_case(4096, 1024, 13, ties=False)
    cases["all_infeasible"] = (
        np.array([[0, 0, 0], [1, 0, 1]], dtype=bool),
        np.array([[1.0], [2.0], [0.5]], dtype=np.float32),
        np.zeros(3, dtype=np.int32), np.zeros(1))
    cases["sentinel_prices"] = (
        np.array([[1, 0, 1]], dtype=bool),
        np.full((3, 1), 3.0e38, dtype=np.float32),
        np.zeros(3, dtype=np.int32), np.zeros(1))
    if large:
        cases["hbm_65536x1024"] = _score_case(65536, 1024, 17, p=0.5,
                                              ties=False)
    return cases


def host_row(base, prov, lam):
    """The reference's host chain: adjusted prices, cheapest domain, bf16."""
    from karpenter_tpu_torch.models.tensorize import pack_scores
    from karpenter_tpu_torch.solver.hierarchy import price_adjusted

    return pack_scores(price_adjusted(base, prov, lam).min(axis=1))


def _same(*outs) -> bool:
    raw = [np.ascontiguousarray(o.cpu().numpy()).tobytes() for o in outs]
    return all(r == raw[0] for r in raw)


def check_packed_entry(f, row) -> float:
    """``packed_scan_scores`` on the card (one launch) against its plain
    version on the card and on the host; returns the max abs cost error,
    fails unless byte-equal."""
    import torch

    from karpenter_tpu_torch.kernels import PACKED_SCORE
    from karpenter_tpu_torch.solver.hierarchy import (
        packed_scan_scores,
        packed_scan_scores_plain,
    )

    before = PACKED_SCORE.launches
    c_k, i_k = packed_scan_scores(f, row.to(f.device))
    torch.cuda.synchronize()
    check(PACKED_SCORE.launches == before + 1, "packed_score did not launch")
    c_p, i_p = packed_scan_scores_plain(f, row.to(f.device))
    c_h, i_h = packed_scan_scores_plain(f.cpu(), row)
    check(_same(c_k, c_p, c_h) and _same(i_k, i_p, i_h),
          f"packed_score differs from its plain version at {tuple(f.shape)}")
    return float((c_k - c_p).abs().max().item()) if c_k.numel() else 0.0


def check_step_entry(f, base, prov, lam) -> float:
    """``price_step_scores`` on the card (one launch) against its plain
    version on the card and on the host, and against the price-row plain
    version on the host chain's row; returns the max abs cost error, fails
    unless byte-equal."""
    import torch

    from karpenter_tpu_torch.kernels import PRICE_STEP_SCORE
    from karpenter_tpu_torch.solver.hierarchy import (
        packed_scan_scores_plain,
        price_step_scores,
        price_step_scores_plain,
        split_scores,
    )

    args = (torch.from_numpy(np.ascontiguousarray(base)),
            torch.from_numpy(np.ascontiguousarray(prov)),
            torch.from_numpy(np.exp(lam).astype(np.float32)))
    dev_args = [a.to(f.device) for a in args]
    before = PRICE_STEP_SCORE.launches
    out_k = price_step_scores(f, *dev_args)
    torch.cuda.synchronize()
    check(PRICE_STEP_SCORE.launches == before + 1,
          "price_step_score did not launch")
    out_p = price_step_scores_plain(f, *dev_args)
    out_h = price_step_scores_plain(f.cpu(), *args)
    c_r, i_r = packed_scan_scores_plain(f.cpu(), host_row(base, prov, lam))
    out_r = torch.stack([c_r.view(torch.int32), i_r])
    check(_same(out_k, out_p, out_h, out_r),
          f"price_step_score differs from its plain version at "
          f"{tuple(f.shape)}")
    c_k, c_p = split_scores(out_k)[0], split_scores(out_p)[0]
    return float((c_k - c_p).abs().max().item()) if c_k.numel() else 0.0


#: the price loop's kernel entries (``csrc/packed_score.cu``): off every
#: path but the hierarchical driver's price loop.  The zone fills
#: (``csrc/zone_fill.cu``) launch on every zoned group step on the card.
PRICE_LOOP = ("packed_score", "price_step_score")


def price_loop(launches: dict) -> dict:
    """The price loop's entries of a launch count."""
    return {name: launches[name] for name in PRICE_LOOP}


#: the zone-fill checks' zone counts and leading shapes (a batch's rows
#: are the product of its leading shape)
FILL_ZONES = (1, 2, 3, 4, 6)
FILL_LEADS = ((), (1,), (32,), (4, 8))
#: rows of each zone count's bulk batch: 5 x 20,480 = 102,400 rows
FILL_BULK = 20_480
#: the group step's float32 sentinels: BIGN (unbounded capacity, no
#: skew) and ops/masks.py's BIG
BIGN = np.float32(1e9)
BIG = np.float32(3.4e38)


def fill_case(lead, Z: int, seed: int):
    """Zone-fill inputs of leading shape ``lead`` from one numpy seed:
    ``(current, rows, cap)`` float32 ``[*lead, Z]``, ``(total, skew)``
    float32 ``[*lead]`` and ``eligible`` bool ``[*lead, Z]``.  Rows draw
    ties (every zone at one count), whole and fractional counts,
    ineligible zones (a few rows with none eligible), zero totals, caps of
    0, fractions, BIGN and BIG, free rows above the cap, and skews of 1,
    2, 5, BIGN and BIG.  In a batch of two rows or more the first is the
    band case whose remainder meets fractional headroom (ROADMAP C2: no
    pods yet, free rows in zone 0 only, 2 pods at maxSkew 1)."""
    rng = np.random.default_rng(seed)
    lead = tuple(lead)
    shape = lead + (Z,)
    current = rng.integers(0, 6, shape).astype(np.float32)
    current += np.where(rng.random(shape) < 0.2,
                        rng.random(shape) * 3, 0).astype(np.float32)
    tie = np.asarray(rng.random(lead) < 0.25)
    current = np.where(tie[..., None], current[..., :1], current)
    cap = rng.choice(np.array([0, 0.5, 1, 1.34, 2, 5, 9, 40, BIGN, BIG],
                              dtype=np.float32), shape)
    rows = rng.choice(np.array([0, 1, 2, 2.5, 3, 6, 40], dtype=np.float32),
                      shape)
    rows = np.where(rng.random(shape) < 0.8, np.minimum(rows, cap), rows)
    total = np.asarray(rng.choice(
        np.array([0, 1, 2, 3, 7, 20, 61, 2500], dtype=np.float32),
        lead)).reshape(lead)
    skew = np.asarray(rng.choice(
        np.array([1, 2, 5, BIGN, BIG], dtype=np.float32), lead)).reshape(lead)
    eligible = rng.random(shape) < 0.8
    eligible &= ~np.asarray(rng.random(lead) < 0.05)[..., None]
    if int(np.prod(lead, dtype=np.int64)) >= 2:
        first = (0,) * len(lead)
        current[first] = 0.0
        rows[first] = 0.0
        rows[first + (0,)] = 6.0
        cap[first] = BIGN
        total[first], skew[first] = 2.0, 1.0
        eligible[first] = True
    return (current.astype(np.float32), rows.astype(np.float32),
            cap.astype(np.float32), total.astype(np.float32),
            skew.astype(np.float32), eligible)


def check_fill_entries(case) -> int:
    """Both zone-fill entries on the card (one launch each) against their
    plain compositions on the card: int32, the same shape, equal on every
    row, or this fails naming the first row that differs.  Returns the
    rows checked."""
    import torch

    from karpenter_tpu_torch.kernels import SKEW_BAND_FILL, WATER_FILL
    from karpenter_tpu_torch.ops import masks

    cur, rows, cap, total, skew, el = (
        torch.from_numpy(np.array(a)).cuda() for a in case)
    before = (SKEW_BAND_FILL.launches, WATER_FILL.launches)
    got = {"skew_band_fill": masks.skew_band_fill(cur, rows, cap, total,
                                                  skew, el),
           "water_fill": masks.water_fill(cur, cap, total, el)}
    torch.cuda.synchronize()
    check((SKEW_BAND_FILL.launches, WATER_FILL.launches)
          == (before[0] + 1, before[1] + 1),
          "a zone-fill entry did not launch once")
    want = {"skew_band_fill": masks.skew_band_fill_plain(
                cur, rows, cap, total, skew, el),
            "water_fill": masks.water_fill_plain(cur, cap, total, el)}
    Z = cur.shape[-1]
    for name, k in got.items():
        p = want[name]
        check(k.dtype == torch.int32 and k.shape == cur.shape,
              f"{name}: {k.dtype} {tuple(k.shape)} for {tuple(cur.shape)}")
        bad = (k != p).reshape(-1, Z).any(dim=1).nonzero()
        if bad.numel():
            r = int(bad[0])
            flat = [a.reshape(-1, Z)[r].tolist() if a.dim() == cur.dim()
                    else a.reshape(-1)[r].item() for a in
                    (cur, rows, cap, total, skew, el)]
            check(False, f"{name} differs from its plain composition on "
                  f"{bad.numel()} of {k.numel() // Z} rows; row {r}: inputs "
                  f"{flat}, kernel {k.reshape(-1, Z)[r].tolist()}, plain "
                  f"{p.reshape(-1, Z)[r].tolist()}")
    return cur.numel() // Z


def fill_cases(draws: int = 4):
    """``name -> case`` of the zone-fill checks: ``draws`` batches of each
    leading shape of :data:`FILL_LEADS`, and one bulk batch of
    :data:`FILL_BULK` rows, for each zone count of :data:`FILL_ZONES`."""
    cases = {}
    for Z in FILL_ZONES:
        for lead in FILL_LEADS:
            for d in range(draws):
                cases[f"z{Z}_{'x'.join(map(str, lead)) or 'row'}_{d}"] = \
                    fill_case(lead, Z, seed=1000 * Z + 10 * len(lead) + d)
        cases[f"z{Z}_bulk"] = fill_case((FILL_BULK,), Z, seed=7 + Z)
    return cases


def phase_kernel():
    """Every entry vs its plain version on the card: the packed-score
    entries byte-equal on every case, the zone fills equal on every row
    of :func:`fill_cases`."""
    import torch

    from karpenter_tpu_torch.models.tensorize import pack_feasibility

    out = {}
    max_err = {"packed_score": 0.0, "price_step_score": 0.0,
               "skew_band_fill": 0.0, "water_fill": 0.0}
    for name, (feas, base, prov, lam) in step_cases(large=True).items():
        f = torch.from_numpy(pack_feasibility(feas)).cuda()
        e1 = check_packed_entry(f, host_row(base, prov, lam))
        e2 = check_step_entry(f, base, prov, lam)
        max_err["packed_score"] = max(max_err["packed_score"], e1)
        max_err["price_step_score"] = max(max_err["price_step_score"], e2)
        out[name] = dict(shape=list(feas.shape) + [base.shape[1]],
                         P=len(lam), byte_equal=True,
                         max_abs_err=max(e1, e2))
        del f
    fill_rows = sum(check_fill_entries(c) for c in fill_cases().values())
    emit("kernel", cases=out, fill_rows=fill_rows, max_abs_err=max_err)
    return max_err


def _time(fn, reps=21, inner=20):
    """Median ms per EAGER call over ``reps`` CUDA-event windows of
    ``inner`` calls: what a caller pays per call, host launch included
    (a tiny kernel's window is bound by the host's launch rate)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _time_graph(fn, reps=21, inner=50):
    """Median DEVICE ms per call: ``inner`` calls captured into one CUDA
    graph, replayed ``reps`` times between CUDA events — no host launch
    cost between the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def phase_slice(nd: int, per: int):
    import torch

    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=True)
    pods = deployments(nd, per)
    t0 = time.perf_counter()
    (sched, st, limit, free, res, stats, wall_ms, launches,
     shipped) = limited_solve(None, pods, catalog)
    check(launches["price_step_score"] >= 1,
          "the main path launched the price_step_score kernel no time")
    check(launches["price_step_score"] == stats["price_iters"],
          "price_step_score launches != price iterations")
    check(launches["packed_score"] == 0,
          "the main path launched the price-row entry")
    emit("slice", pods=len(pods), groups=st.G, candidates=st.C,
         domains=int(st.cand_price.shape[1]), provisioners=len(st.prov_names),
         zones=st.n_zones, blocks=stats["blocks"], waves=stats["waves"],
         price_iters=stats["price_iters"], dispatches=stats["dispatches"],
         wall_ms=wall_ms, tensorize_ms=stats["tensorize_ms"],
         partition_ms=stats["partition_ms"], entries_ms=stats["entries_ms"],
         wave_ms=stats["wave_ms"], score_ms=stats["score_ms"],
         score_setup_ms=stats["score_setup_ms"], price_lam=stats["price_lam"],
         repair_ms=stats["repair_ms"], repair_pods=stats["repair_pods"],
         hier_total_ms=stats["total_ms"],
         relax_outcomes=stats["relax_outcomes"], relax_ms=stats["relax_ms"],
         nodes=len(res.nodes), cost=res.new_node_cost,
         infeasible=len(res.infeasible), cpu_limit=limit,
         cpu_shipped=shipped, free_nodes=len(free.nodes),
         free_cost=free.new_node_cost, launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / GIB,
         phase_s=time.perf_counter() - t0)
    return st, stats, launches, limit, res


def _bound(bytes_moved: int, ops: int) -> dict:
    """The least time for the work: bytes over HBM rate, operations over
    the float32 peak, the larger of the two."""
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1000.0
    bound_ops = ops / F32_FLOPS * 1000.0
    return dict(bytes=bytes_moved, ops=ops,
                bound_ms=max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops else "operations")


def _time_fns(fns: dict) -> dict:
    """Graph-replayed device ms and eager per-call ms of each function, in
    two turns (forward order, then reversed); medians."""
    runs = {k: [] for k in fns}
    calls = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            runs[k].append(_time_graph(fns[k]))
            calls[k].append(_time(fns[k]))
    out = {f"{k}_ms": statistics.median(v) for k, v in runs.items()}
    out.update(call_ms={k: statistics.median(v) for k, v in calls.items()},
               runs=runs)
    return out


def _time_packed(fs, price) -> dict:
    """The price-row entry, its plain version and the one-call yardstick
    on the buffers ``fs`` in turn (two buffers keep a large f out of L2)."""
    import itertools

    import torch

    from karpenter_tpu_torch.solver.hierarchy import (
        _BIG,
        packed_scan_scores,
        packed_scan_scores_plain,
    )

    G, C = fs[0].shape
    nxt = itertools.cycle(fs).__next__
    out = _time_fns({
        "plain": lambda: packed_scan_scores_plain(nxt(), price),
        "kernel": lambda: packed_scan_scores(nxt(), price),
        "library": lambda: torch.min(
            torch.where(nxt() > 0, price.float()[None, :], _BIG), dim=1),
    })
    # one select + one compare per cell
    out.update(shape=[G, C], buffers=len(fs),
               **_bound(G * C + 2 * C + 8 * G, 2 * G * C))
    return out


def _time_step(f, base, prov, mult) -> dict:
    """The fused entry and its plain version (no one PyTorch call computes
    the same function: no library yardstick)."""
    from karpenter_tpu_torch.solver.hierarchy import (
        price_step_scores,
        price_step_scores_plain,
    )

    G, C = f.shape
    D, P = base.shape[1], mult.shape[0]
    out = _time_fns({
        "plain": lambda: price_step_scores_plain(f, base, prov, mult),
        "kernel": lambda: price_step_scores(f, base, prov, mult),
    })
    # f read once, base prices, owners and multipliers once, [2, G] out;
    # a multiply and a min per price cell, a select and a compare per f cell
    out.update(shape=[G, C, D], P=P, library_ms=None,
               **_bound(G * C + 4 * C * D + 4 * C + 4 * P + 8 * G,
                        2 * G * C + 2 * C * D))
    return out


def _fill_work(name: str, rows: int, Z: int) -> dict:
    """The least time of a zone fill of ``rows`` x ``Z``: its inputs read
    once (float32 zoned inputs, the bool mask, float32 per-row scalars),
    its int32 output written once; its operations the bisection rounds'
    float work (per zone and round: the band's target count, 9, or the
    water level's allocation, 3, and one add of the zone sum; a round's
    midpoint, 2)."""
    zoned, per_row = (3, 2) if name == "skew_band_fill" else (2, 1)
    nbytes = rows * (Z * (4 * zoned + 1 + 4) + 4 * per_row)
    band = 48 * (10 * Z + 2) if name == "skew_band_fill" else 0
    ops = rows * (band + 40 * (4 * Z + 2))
    return _bound(nbytes, ops)


def _time_fill(name: str, lead, Z: int) -> dict:
    """A zone-fill entry and its plain composition on one batch of
    :func:`fill_case` inputs of leading shape ``lead`` (no one PyTorch call
    computes the same function: no library yardstick)."""
    import torch

    from karpenter_tpu_torch.ops import masks

    cur, rows, cap, total, skew, el = (
        torch.from_numpy(np.array(a)).cuda()
        for a in fill_case(lead, Z, seed=3))
    if name == "skew_band_fill":
        args = (cur, rows, cap, total, skew, el)
    else:
        args = (cur, cap, total, el)
    kernel, plain = (getattr(masks, name),
                     getattr(masks, f"{name}_plain"))
    out = _time_fns({"plain": lambda: plain(*args),
                     "kernel": lambda: kernel(*args)})
    n = cur.numel() // Z
    out.update(shape=[n, Z], library_ms=None, **_fill_work(name, n, Z))
    return out


def _time_host_step(f_np, base_np, prov_np, lam) -> dict:
    """The price loop's score step as the host pays it (host clock, ends
    with the result on the host), median ms in two turns: ``fused`` is
    ``ScoreStep`` as the loop runs it (exp(lam) up, one launch, one buffer
    back) and ``host_chain`` the host price chain (host price math, bf16
    packing, price row up, the price-row entry, two copies back);
    ``bare_copy`` (one 4-byte copy back from the card) is the floor any
    step that ends on the host pays.  Each runs back to back (``warm``),
    after 20 ms of host-only Python work (``after_host_work``, as between
    the solve's price iterations) and after 20 ms idle (``after_idle``)."""
    import torch

    from karpenter_tpu_torch.models.tensorize import pack_scores
    from karpenter_tpu_torch.solver.hierarchy import (
        ScoreStep,
        packed_scan_scores,
        price_adjusted,
    )

    step = ScoreStep(f_np, base_np, prov_np, len(lam), "cuda")
    f = step.inputs[0]

    def host_chain():
        adj = price_adjusted(base_np, prov_np, lam).min(axis=1)
        cost, idx = packed_scan_scores(f, pack_scores(adj).to(f.device))
        return cost.cpu().numpy(), idx.cpu().numpy()

    def host_work():
        t_end = time.perf_counter() + 0.02
        while time.perf_counter() < t_end:
            sum(range(1000))

    one = torch.zeros(1, device="cuda")
    fns = {"fused": lambda: step(lam), "host_chain": host_chain,
           "bare_copy": lambda: one.cpu()}
    (ca, ia), (cb, ib) = fns["fused"](), host_chain()
    check(ca.tobytes() == cb.tobytes() and ia.tobytes() == ib.tobytes(),
          "the fused score step and the host chain disagree")
    out = {}
    for cond, before, reps in (
            ("warm", None, 100),
            ("after_host_work", host_work, 30),
            ("after_idle", lambda: time.sleep(0.02), 30)):
        times = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                for _ in range(5):
                    fns[k]()
                for _ in range(reps):
                    if before is not None:
                        before()
                    t0 = time.perf_counter()
                    fns[k]()
                    times[k].append((time.perf_counter() - t0) * 1000.0)
        out[cond] = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    return out


def phase_timing(st, stats):
    """Both entries at the main path's inputs (the slice's feasibility, base
    prices, owners and last duals), the score step as the host pays it,
    and the price-row entry at 4,096 x 1,024 and at 65,536 x 1,024 (64 MiB
    of f in each of two buffers, used in turn, so the 50 MB L2 does not
    hold the next call's f)."""
    import torch

    from karpenter_tpu_torch.models.tensorize import pack_feasibility
    from karpenter_tpu_torch.solver.relax import _host_feasibility

    f_np = pack_feasibility(_host_feasibility(st))
    f = torch.from_numpy(f_np).cuda()
    # the padded base's first C rows: no-offering cells at the sentinel
    base_np = np.where(np.isinf(st.cand_price), np.float32(3.0e38),
                       st.cand_price).astype(np.float32)
    prov_np = np.asarray(st.cand_prov, dtype=np.int32)
    lam = np.asarray(stats["price_lam"], dtype=np.float64)
    base, prov = torch.from_numpy(base_np).cuda(), torch.from_numpy(
        prov_np).cuda()
    mult = torch.from_numpy(np.exp(lam).astype(np.float32)).cuda()
    out = dict(
        packed=_time_packed([f], host_row(base_np, prov_np, lam).cuda()),
        step=_time_step(f, base, prov, mult),
        host_step=_time_host_step(f_np, base_np, prov_np, lam),
    )
    feas, base_l, _, _ = _score_case(4096, 1024, 13, ties=False)
    out["packed_4096x1024"] = _time_packed(
        [torch.from_numpy(pack_feasibility(feas)).cuda()],
        host_row(base_l, np.zeros(1024, dtype=np.int32), np.zeros(1)).cuda())
    fs = []
    for seed in (17, 18):
        feas, base_h, _, _ = _score_case(65536, 1024, seed, ties=False)
        fs.append(torch.from_numpy(pack_feasibility(feas)).cuda())
        del feas
    out["packed_65536x1024"] = _time_packed(
        fs, host_row(base_h, np.zeros(1024, dtype=np.int32),
                     np.zeros(1)).cuda())
    out.update(fill_timings())
    emit("timing", **out)
    return out


def fill_timings() -> dict:
    """Both zone-fill entries at the burst's shape (1 row, Z = 3) and the
    megabatch's (32 rows, Z = 3), keyed ``<entry>_<rows>x<Z>``."""
    return {f"{name}_{rows}x3": _time_fill(name, (rows,), 3)
            for name in ("skew_band_fill", "water_fill") for rows in (1, 32)}


def phase_parity(nd: int, per: int):
    """The same limited hierarchical solve on cuda and on cpu."""
    import torch

    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=True)
    pods = deployments(nd, per, tag="p")
    runs = {}
    with hier_at(len(pods)):
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            (_s, _st, limit, _free, res, stats, _w, _l,
             _shipped) = limited_solve(dev, pods, catalog)
            runs[dev] = (limit, res, stats, time.perf_counter() - t0)
    (lg, rg, sg, tg), (lc, rc, sc, tc) = runs["cuda"], runs["cpu"]
    equal = plan(rg) == plan(rc)
    tie = placements_tie(rg, rc)
    check(lg == lc, f"cuda and cpu bought differently unconstrained "
          f"(limits {lg} vs {lc})")
    check(equal or tie, "cuda and cpu node plans disagree")
    emit("parity", pods=len(pods), cpu_limit=lg, plans_equal=equal,
         placements_tie=tie, price_iters=[sg["price_iters"],
                                          sc["price_iters"]],
         nodes=[len(rg.nodes), len(rc.nodes)],
         cost=[rg.new_node_cost, rc.new_node_cost], seconds=[tg, tc],
         torch_threads=torch.get_num_threads())


def phase_reference(nd: int, per: int):
    """The plan the later paths' hierarchical solves are held to: the
    limited solve of :data:`LATER_HIER`'s batch on the card, as the slice
    solves its own.  Returns (tensors, stats, limit, result)."""
    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=True)
    pods = deployments(nd, per)
    with hier_at(len(pods)):
        (_s, st, limit, free, res, stats, wall_ms, launches,
         shipped) = limited_solve(None, pods, catalog, LATER_HIER_LIMIT)
    check(launches["price_step_score"] == stats["price_iters"] >= 1,
          "the reference solve's price_step_score launches != its price "
          "iterations")
    emit("reference", pods=len(pods), groups=st.G, blocks=stats["blocks"],
         price_iters=stats["price_iters"], wall_ms=wall_ms,
         wave_ms=stats["wave_ms"], nodes=len(res.nodes),
         cost=res.new_node_cost, infeasible=len(res.infeasible),
         cpu_limit=limit, cpu_shipped=shipped, free_nodes=len(free.nodes))
    return st, stats, limit, res


# ---------------------------------------------------------------------------
# relax and consolidation scenarios
# ---------------------------------------------------------------------------


def check_plan(pods, res, provisioners, st) -> None:
    """Every pod seated exactly once, no node over its allocatable, every
    provisioner within its limits."""
    names = [p.name for p in pods]
    seated = [q.name for n in res.nodes for q in n.pods]
    check(not res.infeasible, f"{len(res.infeasible)} pods left infeasible")
    check(sorted(seated) == sorted(names) and set(res.assignments)
          == set(names), "a pod is not seated exactly once")
    check(all(v >= -1e-6 for n in res.nodes for v in n.remaining().values()),
          "a node is over its allocatable")
    for prov in provisioners:
        for r, limit in (prov.limits or {}).items():
            used = sum(float(st.capacity_row(n.instance_type, n.allocatable)[
                st.vocab.resources.index(r)])
                for n in res.nodes if n.provisioner == prov.name)
            check(used <= limit * (1 + 1e-6),
                  f"provisioner {prov.name} over its {r} limit")


def _outcomes(registry) -> dict:
    from karpenter_tpu_torch.metrics import RELAX_OUTCOMES, RELAX_TOTAL

    return {o: registry.counter(RELAX_TOTAL).get({"outcome": o})
            for o in RELAX_OUTCOMES}


def _hist_sum(registry, name) -> float:
    return sum(registry.histogram(name).sums.values())


def _synced_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1000.0


def count_launches(fn):
    """CUDA kernel launches of one call of ``fn`` (torch.profiler's
    ``cudaLaunchKernel`` runtime calls); None when the profiler records
    none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.key.startswith("cudaLaunchKernel"))
    return n or None


def profile_busy(fn) -> dict:
    """One traced call of ``fn`` (torch.profiler): its CUDA kernel launches,
    the device time of its kernels, the traced wall, and their ratio (the
    device's busy share, under tracing; None when no kernel time is
    recorded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1000.0
    kernel_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key.startswith("cudaLaunchKernel"))
    return dict(launches=launches or None, kernel_ms=kernel_us / 1000.0,
                traced_wall_ms=wall_ms,
                busy_share=(kernel_us / 1000.0 / wall_ms) if kernel_us
                else None)


def _first_diff(a, b):
    """The first differing entry of two node plans, by type, zone, price
    and pod count (None when the plans are equal)."""
    for x, y in zip(plan(a), plan(b)):
        if x != y:
            return [list(x[:4]) + [len(x[4])], list(y[:4]) + [len(y[4])],
                    sorted(set(x[4]) ^ set(y[4]))[:4]]
    return None if plan(a) == plan(b) else "node counts differ"


def relax_case(pods, catalog):
    """The scan and the default solve of ``pods`` on the card, then the
    default solve on the host; checks and numbers of the rung."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics import RELAX_DURATION, Registry
    from karpenter_tpu_torch.solver import relax
    from karpenter_tpu_torch.solver.relax import RELAX_PROGRAM
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    provs = [provisioner()]
    reg = Registry()
    sched = BatchScheduler(backend="tpu", registry=reg)
    scan, scan_ms = _synced_ms(lambda: sched.solve(pods, provs, catalog,
                                                   relax=False))
    before = _outcomes(reg)
    relax_s0 = _hist_sum(reg, RELAX_DURATION)
    RELAX_PROGRAM.reset()
    kernels.reset_counts()
    shipped, shipped_ms = _synced_ms(lambda: sched.solve(pods, provs,
                                                         catalog))
    runs = dict(RELAX_PROGRAM.runs)
    launches = {k.name: k.launches for k in kernels.ALL}
    outcomes = {o: v - before[o] for o, v in _outcomes(reg).items()}
    st, _ = sched._tensorize(pods, provs, catalog, (), None)
    # 'fallback' also counts a rounding that came out costlier than the
    # scan (the scan ships); a fallback from an exception logs a warning
    check(not FAULTS.records, f"the port fell back: {FAULTS.records}")
    check(sum(outcomes.values()) == 1, "the rung was not evaluated once")
    check(runs.get("cuda", 0) >= 1 or outcomes["skipped"] == 1,
          "the relax program did not run on the card")
    check(runs.get("cpu", 0) == 0, "the relax program ran on the host")
    check(shipped.new_node_cost <= scan.new_node_cost + 1e-9,
          "the rung shipped a costlier plan than the scan")
    check_plan(pods, scan, provs, st)
    check_plan(pods, shipped, provs, st)
    t0 = time.perf_counter()
    host_reg = Registry()
    host = BatchScheduler(backend="tpu", device="cpu",
                          registry=host_reg).solve(pods, provs, catalog)
    cpu_s = time.perf_counter() - t0
    equal = plan(host) == plan(shipped)
    check(equal or placements_tie(host, shipped),
          "the cuda and cpu default solves seat different pods or cost "
          "differently")
    check(_outcomes(host_reg) == outcomes,
          "the cuda and cpu solves counted different relax outcomes")
    program_equal = None
    if runs.get("cuda"):
        # the program's bits on both devices, on the card scan's inputs
        _e, freed, lifted, seats = relax.eligible_partition(st, scan)
        inputs = relax.relax_inputs(st, scan, lifted, seats, freed,
                                    relax._host_feasibility(st))
        iters = relax.iter_rung(relax.configured_iters())
        bx_g, bf_g = relax._run_relax(*inputs, iters, "cuda")
        bx_c, bf_c = relax._run_relax(*inputs, iters, "cpu")
        program_equal = bx_g.tobytes() == bx_c.tobytes() and bf_g == bf_c
        check(program_equal, "the relax program's bits differ on cuda "
              "and cpu")
    return sched, scan, dict(
        pods=len(pods), groups=st.G, candidates=st.C, scan_ms=scan_ms,
        shipped_ms=shipped_ms,
        relax_ms=(_hist_sum(reg, RELAX_DURATION) - relax_s0) * 1000.0,
        outcomes=outcomes, program_runs=runs, kernel_launches=launches,
        scan_cost=scan.new_node_cost, shipped_cost=shipped.new_node_cost,
        cost_ratio=shipped.new_node_cost / scan.new_node_cost,
        scan_nodes=len(scan.nodes), shipped_nodes=len(shipped.nodes),
        cpu_plan_equal=equal, cpu_placements_tie=placements_tie(host, shipped),
        cpu_first_diff=_first_diff(shipped, host),
        program_bits_equal_cpu=program_equal, cpu_solve_s=cpu_s)


def time_relax_program(sched, scan, pods, catalog) -> dict:
    """The relax program alone on the 50,000-pod inputs (the scan's
    partition): device ms per call (CUDA events around one call, median
    of three), wall ms per call, kernel launches per call."""
    import torch

    from karpenter_tpu_torch.solver import relax

    st, _ = sched._tensorize(pods, [provisioner()], catalog, (), None)
    elig, freed, lifted, seats = relax.eligible_partition(st, scan)
    inputs = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
              for a in relax.relax_inputs(st, scan, lifted, seats, freed,
                                          relax._host_feasibility(st))]
    iters = relax.iter_rung(relax.configured_iters())

    def call():
        return relax._relax_program(*inputs, iters)

    call()
    dev_ms, wall_ms = [], []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        call()
        b.record()
        b.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1000.0)
        dev_ms.append(a.elapsed_time(b))
    return dict(shape=[list(x.shape) for x in inputs[:1] + inputs[2:3]],
                iters=iters, device_ms=statistics.median(dev_ms),
                wall_ms=statistics.median(wall_ms),
                launches_per_call=count_launches(call))


def phase_relax():
    import bench_torch as bt
    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=True)
    t0 = time.perf_counter()
    pods = bt._relax_pods(2500)
    sched, scan, big = relax_case(pods, catalog)
    check(big["outcomes"]["improved"] == 1 and big["outcomes"]["fallback"] == 0,
          "the rung did not improve the 50,000-pod unconstrained batch")
    program = time_relax_program(sched, scan, pods, catalog)
    _s, _scan, mixed = relax_case(bt._relax_pods(250, spread_deps=10), catalog)
    emit("relax", unconstrained_50k=big, mixed_5k=mixed, program=program,
         phase_s=time.perf_counter() - t0)


def config4_fleet(n: int):
    """``n`` 16-cpu nodes, each holding 1–4 pods of 0.5/1/2 cpu
    (``RandomState(7)``): an under-utilised fleet."""
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.solver.types import SimNode

    rng = np.random.RandomState(7)
    nodes = []
    for i in range(n):
        node = SimNode(
            instance_type="m5.xlarge", provisioner="default", zone="zone-1a",
            capacity_type="on-demand", price=0.192,
            allocatable={"cpu": 16.0, "memory": 64 * GIB, "pods": 50.0},
            labels={ZONE: "zone-1a"}, name=f"n{i}")
        for j, c in enumerate(rng.choice([0.5, 1.0, 2.0],
                                         size=rng.randint(1, 5))):
            node.pods.append(PodSpec(name=f"n{i}-p{j}",
                                     requests={"cpu": float(c)}))
        nodes.append(node)
    return nodes


def _decision(res):
    return (not res.infeasible, len(res.nodes), round(res.new_node_cost, 9))


def time_screen_program(nodes) -> dict:
    """The screen program alone on the single-node screen's device inputs
    (pmax 8): device ms per call (CUDA events around one call, median of
    three), wall ms per call (ending with the result on the host), kernel
    launches per call."""
    import torch

    from karpenter_tpu_torch.solver import consolidation as cons

    captured = {}
    real = cons._screen_program

    def spy(*args):
        captured["args"] = args
        return real(*args)

    cons._screen_program = spy
    try:
        cons.screen_delete_candidates(nodes, pmax=8, device="cuda")
    finally:
        cons._screen_program = real
    args = captured["args"]

    def call():
        return real(*args)

    call()
    dev_ms, wall_ms = [], []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        out = call()
        b.record()
        out.cpu()
        wall_ms.append((time.perf_counter() - t0) * 1000.0)
        dev_ms.append(a.elapsed_time(b))
    return dict(shape=[list(t.shape) for t in args],
                device_ms=statistics.median(dev_ms),
                wall_ms=statistics.median(wall_ms),
                launches_per_call=count_launches(call))


def phase_consolidation():
    import torch

    import bench_torch as bt
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.solver import consolidation as cons
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    t0 = time.perf_counter()
    nodes = config4_fleet(5000)
    torch.cuda.reset_peak_memory_stats()
    cons.SCREEN_PROGRAM.reset()
    kernels.reset_counts()
    gpu = cons.screen_delete_candidates(nodes, pmax=8, measure=True,
                                        device="cuda")
    screen_runs = dict(cons.SCREEN_PROGRAM.runs)
    screen_launches = {k.name: k.launches for k in kernels.ALL}
    peak = torch.cuda.max_memory_allocated() / GIB
    check(screen_runs.get("cuda", 0) >= 1 and not screen_runs.get("cpu"),
          "the screen did not run on the card")
    t1 = time.perf_counter()
    host = cons.screen_delete_candidates(nodes, pmax=8, device="cpu")
    cpu_s = time.perf_counter() - t1
    check(gpu.deletable.tolist() == host.deletable.tolist(),
          "the cuda and cpu screens disagree")
    check(gpu.deletable.mean() > 0.5,
          "the under-utilised fleet is not mostly deletable")
    program = time_screen_program(nodes)
    screen = dict(nodes=len(nodes), deletable_frac=float(gpu.deletable.mean()),
                  eval_ms=gpu.eval_ms, first_ms=gpu.compile_ms,
                  program_runs=screen_runs, kernel_launches=screen_launches,
                  program=program,
                  peak_mem_gib=peak, cpu_s=cpu_s)

    catalog = generate_catalog(full=False)
    cluster = bt._sweep_cluster()
    cands = [[i] for i in range(16)]
    prov = provisioner()
    sched = BatchScheduler(backend="tpu")
    kernels.reset_counts()
    sweep, sweep_ms = _synced_ms(lambda: cons.sweep_what_ifs(
        sched, cluster, cands, provisioners=[prov], instance_types=catalog,
        max_new=1))
    sweep_kernel_launches = {k.name: k.launches for k in kernels.ALL}
    check(not FAULTS.records, f"the port fell back: {FAULTS.records}")
    check(sweep.path == "batched" and sweep.n_serial == 0
          and sweep.dispatches == 1,
          f"the sweep was not one batched dispatch ({sweep.path}, "
          f"{sweep.n_serial} serial, {sweep.dispatches} dispatches)")

    def serial():
        out = []
        for k in range(len(cands)):
            others = [n for j, n in enumerate(cluster) if j != k]
            out.append(sched.solve(
                [p for p in cluster[k].pods if not p.is_daemon], [prov],
                catalog, existing_nodes=others, allow_new_nodes=True,
                max_new_nodes=1))
        return out

    serial_res, serial_ms = _synced_ms(serial)
    check([_decision(r) for r in sweep.results]
          == [_decision(r) for r in serial_res],
          "sweep decisions differ from the serial what-if loop")
    sweep_launches = count_launches(lambda: cons.sweep_what_ifs(
        sched, cluster, cands, provisioners=[prov], instance_types=catalog,
        max_new=1))
    emit("consolidation", screen=screen, sweep=dict(
        nodes=len(cluster), candidates=len(cands), path=sweep.path,
        dispatches=sweep.dispatches, n_batched=sweep.n_batched,
        n_serial=sweep.n_serial, sweep_ms=sweep_ms,
        sweep_wall_ms=sweep.wall_ms, serial_ms=serial_ms,
        sweep_launches=sweep_launches,
        kernel_launches=sweep_kernel_launches,
        deletable=sum(1 for r in sweep.results if not r.infeasible
                      and not r.nodes)),
        phase_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 9: the controllers
# ---------------------------------------------------------------------------


#: fleet sizes of the repack runs.  The reference bench's config 4 runs
#: one reconcile at 5,000 nodes and the ladder to convergence at 2,000; on
#: the card the port's what-if solves are launch-bound (about 10 s for a
#: what-if over 240 of 300 nodes), so a full evaluation at 5,000 nodes
#: does not fit this script's time: the screen step runs at 5,000, the
#: rest at these sizes, cut again (from 300 and 200) when phase 11 came in,
#: the convergence again (from 150) when phase 12 came in and (from 100,
#: then 60 and 40) when phase 17 did and (from 40) when phase 18 did, and
#: the one full reconcile again (from 200) when phase 16(c) came in and
#: (from 100) when phase 18 did (PERF.md §4); (c)'s cuda-vs-cpu parity runs
#: at the convergence's size, its cuda run being (b)'s
REPACK_SIZES = {"screen": 5000, "reconcile": 50, "converge": 20}


def provision_through_controller(catalog, limit, pods):
    """A batch through ``ProvisioningController``: pods added to a
    ``ClusterState`` under a provisioner at ``limit``, reconcile, the
    batching window passed, reconcile again.  Returns the state, the
    cloud, the scheduler, the result, the controller wall ms and the
    launch counts of that run."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.cloud.fake import FakeCloudProvider
    from karpenter_tpu_torch.controllers.provisioning import (
        ProvisioningController,
    )
    from karpenter_tpu_torch.controllers.state import ClusterState
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.utils.clock import FakeClock

    clock = FakeClock()
    state = ClusterState(clock=clock)
    state.apply_provisioner(provisioner(limit))
    cloud = FakeCloudProvider(catalog, clock=clock)
    reg = Registry()
    sched = BatchScheduler(backend="auto", registry=reg)
    ctrl = ProvisioningController(state, cloud, scheduler=sched,
                                  registry=reg, clock=clock)
    for p in pods:
        state.add_pod(p)
    kernels.reset_counts()
    t0 = time.perf_counter()
    first = ctrl.reconcile()
    clock.advance(1.5)
    res = ctrl.reconcile()
    wall_ms = (time.perf_counter() - t0) * 1000.0
    launches = {k.name: k.launches for k in kernels.ALL}
    check(first is None, "the controller solved before its window closed")
    check(res is not None, "the controller did not solve the batch")
    return state, cloud, sched, res, wall_ms, launches


def phase_controllers(slice_limit, slice_res, pods):
    """(a) the reference's batch ``pods`` provisioned through the controller
    under the reference's limit, against the reference's plan; on the repack
    fleet at the sizes of :data:`REPACK_SIZES`, (b) the consolidation
    evaluation's screen step, one full reconcile and the ladder to
    convergence, and (c) a fleet driven to convergence on ``cuda`` and on
    ``cpu``, equal decisions."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics import (
        HIER_SOLVES,
        PROVISIONER_USAGE,
        SCHEDULING_DURATION,
    )
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.repack import (
        cluster_faults,
        cluster_plan,
        one_reconcile_at,
        repack_to_convergence,
        reset_name_counters,
        screen_at,
    )
    from karpenter_tpu_torch.solver import consolidation as cons

    catalog = generate_catalog(full=True)
    t_phase = time.perf_counter()

    # (a) provisioning through the controller
    with hier_at(len(pods)):
        state, cloud, sched, res, wall_ms, launches = \
            provision_through_controller(catalog, slice_limit, pods)
    reg = sched.registry
    stats = dict(sched.hier_stats)
    check(reg.counter(HIER_SOLVES).get({"path": "hierarchical"}) == 1,
          "the controller's solve did not route hierarchically")
    check(launches["price_step_score"] >= 1
          and launches["price_step_score"] == stats["price_iters"],
          "price_step_score launches != price iterations in the "
          "controller's solve")
    check(launches["packed_score"] == 0,
          "the controller's solve launched the price-row entry")
    equal = plan(res) == plan(slice_res)
    tie = placements_tie(res, slice_res)
    check(equal or tie, "the controller's plan differs from the "
          "reference's")
    # every pod of the plan bound to a node that exists (the reference's plan
    # leaves none infeasible; a smaller batch may)
    faults = cluster_faults(state, cloud, unbound_ok=res.infeasible)
    check(not faults, f"the provisioned cluster is unsound: {faults[:5]}")
    raw_cap = {it.name: it.capacity for it in catalog}
    shipped = sum(raw_cap[ns.node.instance_type]["cpu"]
                  for ns in state.nodes.values())
    check(shipped <= slice_limit * (1.0 + 1e-6),
          f"shipped cpu {shipped} exceeds the limit {slice_limit}")
    usage = reg.gauge(PROVISIONER_USAGE).get(
        {"provisioner": "default", "resource_type": "cpu"})
    check(abs(usage - shipped) <= 1e-6 * shipped,
          f"the usage gauge ({usage}) disagrees with the launched nodes")
    provision = dict(
        pods=len(pods), nodes=len(state.nodes), cost=res.new_node_cost,
        infeasible=len(res.infeasible), bound=len(state.bindings),
        cpu_limit=slice_limit, cpu_shipped=shipped, plan_equal=equal,
        placements_tie=tie, controller_wall_ms=wall_ms,
        solve_wall_ms=_hist_sum(reg, SCHEDULING_DURATION) * 1000.0,
        hier_total_ms=stats.get("total_ms"),
        price_iters=stats.get("price_iters"), launches=launches)
    del state, cloud, sched, res
    emit("controllers_provision", **provision)

    # (b) the evaluation's screen step at config-4 width, one full
    # reconcile, then the ladder to convergence
    reset_name_counters()
    kernels.reset_counts()
    screen = screen_at(catalog, REPACK_SIZES["screen"], None)
    screen["kernel_launches"] = {k.name: k.launches for k in kernels.ALL}
    check(screen["screen_program_runs"] == {"cuda": 1},
          "the controller's screen step did not run once on the card")
    check(screen["singles_deletable"] > screen["candidates"] // 2,
          "the under-utilised fleet is not mostly deletable")
    check(not any(price_loop(screen["kernel_launches"]).values()),
          "a price-loop kernel launched on the screen step")
    emit("controllers_screen", **screen)

    reset_name_counters()
    _state, reconcile = one_reconcile_at(catalog, REPACK_SIZES["reconcile"],
                                         None)
    check(reconcile["screen_program_runs"].get("cuda", 0) >= 1
          and not reconcile["screen_program_runs"].get("cpu"),
          "the reconcile's screen did not run on the card")
    check(reconcile["proposed"] is not None,
          "the full reconcile proposed no action")
    check(not any(price_loop(reconcile["kernel_launches"]).values()),
          "a price-loop kernel launched on the consolidation path")
    check(not reconcile["settled_faults"],
          f"the settled cluster is unsound: {reconcile['settled_faults']}")
    del _state
    emit("controllers_reconcile", **reconcile)

    reset_name_counters()
    cons.SCREEN_PROGRAM.reset()
    kernels.reset_counts()
    t0 = time.perf_counter()
    state, repack, keys = repack_to_convergence(
        catalog, REPACK_SIZES["converge"], "auto", None)
    converge_s = time.perf_counter() - t0
    repack["kernel_launches"] = {k.name: k.launches for k in kernels.ALL}
    check(not any(price_loop(repack["kernel_launches"]).values()),
          "a price-loop kernel launched on the repack path")
    check(repack["pending_end"] == 0, "pods left pending after the repack")
    faults = cluster_faults(state)
    check(not faults, f"the repacked cluster is unsound: {faults[:5]}")
    check(repack["final_cost"] < repack["initial_cost"],
          "the repack did not lower the fleet's cost")
    repack["screen_program_runs"] = dict(cons.SCREEN_PROGRAM.runs)
    check(repack["screen_program_runs"].get("cuda", 0) >= 1
          and not repack["screen_program_runs"].get("cpu"),
          "the repack's screens did not run on the card")
    # (c) the same decisions on cuda and on cpu: the cuda run is (b)'s
    # convergence, from the same counters at the same size
    cuda_run = (keys, cluster_plan(state), dict(state.bindings), repack,
                converge_s)
    del state
    emit("controllers_repack", **repack)

    reset_name_counters()
    cons.SCREEN_PROGRAM.reset()
    t0 = time.perf_counter()
    st, info, keys = repack_to_convergence(
        catalog, REPACK_SIZES["converge"], "auto", "cpu")
    cpu_run = (keys, cluster_plan(st), dict(st.bindings), info,
               time.perf_counter() - t0)
    faults = cluster_faults(st)
    check(not faults, f"the cpu parity cluster is unsound: {faults[:5]}")
    check(set(cons.SCREEN_PROGRAM.runs) == {"cpu"},
          f"the cpu parity run screened on {cons.SCREEN_PROGRAM.runs}")
    (kg, pg, bg, ig, tg), (kc, pc, bc, ic, tc) = cuda_run, cpu_run
    check(kg == kc, f"cuda and cpu decided differently: {kg} vs {kc}")
    check(pg == pc and bg == bc,
          "cuda and cpu converged to different clusters")
    check(ig["final_cost"] < ig["initial_cost"] and ig["pending_end"] == 0,
          "the parity fleet did not converge")
    check(not FAULTS.records, f"the port fell back: {FAULTS.records}")
    emit("controllers_parity", nodes=REPACK_SIZES["converge"],
         actions=len(kg),
         action_nodes=ig["action_nodes"], decisions_equal=True,
         final_plan_equal=True, nodes_end=ig["nodes_end"],
         final_cost=ig["final_cost"], cuda_s=tg, cpu_s=tc,
         cuda_phase_s=ig["phase_s"], cpu_phase_s=ic["phase_s"])
    emit("controllers", phase_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# serving: the megabatch collector, async dispatch and delta solving
# ---------------------------------------------------------------------------


#: phase 10's sizes: the reference bench's widths (``measure_throughput``'s
#: 32 clients x 320 pods, ``measure_warmstart``'s 20,000 pods, churn 8, 40
#: steps); the constrained chain's step count is this script's choice (20,
#: cut to 10 when phase 17 came in and to 5 when phase 18 did); the serial
#: baseline solves the first ``serial`` requests alone (all 32, cut to 8
#: when phase 17 came in and to 4 when phase 18 did: each takes about 1 s
#: on the card)
SERVING = {"clients": 32, "flushes": (1, 8, 32), "serial": 4,
           "ws_pods": 20_000, "churn": 8, "ws_steps": 40, "spread_steps": 5}


def spread_deployment(tag: str, n: int):
    """One new zone-spread deployment of ``n`` pods: a delta add whose
    displaced subproblem takes the scan tier."""
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodSpec,
        TopologySpreadConstraint,
    )

    sel = LabelSelector.of({"app": tag})
    return [PodSpec(
        name=f"{tag}-{i}", labels={"app": tag},
        requests={"cpu": 0.5, "memory": 1.0 * GIB},
        topology_spread=[TopologySpreadConstraint(
            1, ZONE, "DoNotSchedule", sel)],
        owner_key=tag) for i in range(n)]


def names_from(start: int = 1000) -> None:
    """Restart the auto node-name counter at ``start``: coalescing orders
    candidates by ``(size, name)``, so two solves compare node for node
    only from the same counter state, and 4-digit names keep a request's
    string order its creation order."""
    from karpenter_tpu_torch.solver import types

    with types._node_lock:
        types._node_next = start


def flush(sched, pods_list, provs, catalog):
    """One ``submit_many`` flush with ``.result()`` on every handle, from
    names at 1000; returns (results, wall ms)."""
    names_from()
    reqs = [dict(pods=p, provisioners=provs, instance_types=catalog)
            for p in pods_list]
    return _sync_any(sched.device,
                     lambda: [h.result() for h in sched.submit_many(reqs)])


def count_syncs(fn):
    """Host syncs ``fn`` makes on the card (``set_sync_debug_mode("warn")``
    warnings): returns (fn's value, syncs)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def resolve_from_two_threads(sched, reqs) -> bool:
    """One flush whose handles two threads resolve at once, in opposite
    orders: both must get the same result objects (one read-back)."""
    import threading

    names_from()
    handles = sched.submit_many(reqs)
    got = [None, None]
    barrier = threading.Barrier(2)

    def resolve(i, order):
        barrier.wait()
        got[i] = {j: handles[j].result() for j in order}

    threads = [threading.Thread(target=resolve, args=(0, range(len(reqs)))),
               threading.Thread(target=resolve,
                                args=(1, range(len(reqs) - 1, -1, -1)))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300.0)
    return (not any(th.is_alive() for th in threads)
            and all(got[0][j] is got[1][j] for j in range(len(reqs))))


def sync_calibration() -> int:
    """The syncs :func:`count_syncs` sees for one 4-byte copy back: 1 when
    the count works."""
    import torch

    one = torch.zeros(1, device="cuda")
    return count_syncs(lambda: one.cpu())[1]


def serving_megabatch(catalog):
    """(a): flushes of 1, 8 and 32 serving requests against the serial
    baseline of the first ``SERVING["serial"]`` requests; every flushed
    plan of those against its solo plan; the 32-flush on ``cpu``; one
    flush's launches and host syncs.  The reference plans returned are the
    solo plans, then the 32-flush's (held to the ``cpu`` flush) for the
    requests past the serial ones."""
    import bench_torch as bt
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics import (
        MEGABATCH_SLOTS,
        SOLVER_COLD_FALLBACKS,
        Registry,
    )
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    provs = [provisioner()]
    clients = [bt._serving_pods(c) for c in range(SERVING["clients"])]
    reg = Registry()
    sched = BatchScheduler(backend="auto", registry=reg)
    # warm the request's shape alone and at the flush rungs through the
    # warm API, as the reference bench does before it measures
    st, _ = sched._tensorize_cache.tensorize(clients[0], provs, catalog)
    t0 = time.perf_counter()
    warms = [sched._tpu.warm_async(st, on_done=sched._warm_done, slots=s)
             for s in (None,) + SERVING["flushes"][1:]]
    while not sched._tpu.warm_idle():
        time.sleep(0.05)
    warm_s = time.perf_counter() - t0
    check(all(warms) and all(sched._tpu.ready(sched._tpu.mega_signature(
        st, slots=s)) for s in SERVING["flushes"][1:]),
          "the serving warms did not run")
    # the serial baseline: each request alone through solve (the rung skips
    # zone-spread batches; relax=False keeps it the flush's path)
    solo, serial_ms = [], []
    for pods in clients[:SERVING["serial"]]:
        names_from()
        res, ms = _synced_ms(lambda pods=pods: sched.solve(
            pods, provs, catalog, relax=False))
        solo.append(res)
        serial_ms.append(ms)
    check(all(not r.infeasible for r in solo), "a serving request left "
          "pods infeasible")
    h = reg.histogram(MEGABATCH_SLOTS)
    out = dict(requests=len(clients), pods_per_request=len(clients[0]),
               groups=st.G, warm_s=warm_s, serial_requests=len(solo),
               serial_ms=serial_ms, serial_total_ms=sum(serial_ms),
               serial_solves_per_s=len(solo) / (sum(serial_ms) / 1000.0))
    flushes = {}
    kernels.reset_counts()
    for n in SERVING["flushes"]:
        results, wall_ms = flush(sched, clients[:n], provs, catalog)
        equal = [plan(r) == plan(s) for r, s in zip(results, solo)]
        check(all(equal), f"a request of the {n}-flush planned differently "
              f"from its solo solve ({equal.count(False)} of {len(equal)})")
        check(not any(r.served_cold for r in results),
              "a flushed request was served cold")
        flushes[n] = dict(wall_ms=wall_ms,
                          solves_per_s=n / (wall_ms / 1000.0),
                          vs_serial=(n / (wall_ms / 1000.0))
                          / out["serial_solves_per_s"],
                          plans_equal_solo=sum(equal), results=results)
    check(sum(h.totals.values()) == len(SERVING["flushes"])
          and sum(h.sums.values()) == sum(SERVING["flushes"]),
          f"MEGABATCH_SLOTS did not observe the rungs "
          f"{SERVING['flushes']}: {dict(h.sums)} / {dict(h.totals)}")
    check(reg.counter(SOLVER_COLD_FALLBACKS).get({"backend": "native"})
          + reg.counter(SOLVER_COLD_FALLBACKS).get({"backend": "oracle"})
          == 0, "a cold fallback was counted")
    check(not any(price_loop(kernels.counts()).values()),
          "a price-loop kernel launched on the serving flushes")
    # the 32-flush on the host
    host = BatchScheduler(backend="auto", device="cpu")
    host_res, cpu_ms = flush(host, clients, provs, catalog)
    big = flushes[SERVING["flushes"][-1]]["results"]
    cpu_equal = [plan(a) == plan(b) for a, b in zip(big, host_res)]
    check(all(e or placements_tie(a, b)
              for e, a, b in zip(cpu_equal, big, host_res)),
          "the 32-flush on cuda and on cpu disagree")
    solo += big[len(solo):]
    # one 8-flush's launches (profiler) and host syncs, split into the
    # enqueue half (submit_many) and the read-back half (.result())
    reqs = [dict(pods=p, provisioners=provs, instance_types=catalog)
            for p in clients[:8]]
    traced = profile_busy(
        lambda: [x.result() for x in sched.submit_many(reqs)])
    names_from()
    handles, enqueue_syncs = count_syncs(lambda: sched.submit_many(reqs))
    _r, read_syncs = count_syncs(lambda: [x.result() for x in handles])
    calibration = sync_calibration()
    threads_agree = resolve_from_two_threads(sched, reqs)
    check(threads_agree, "two threads resolving one flush disagree")
    for n in flushes:
        flushes[n].pop("results")
    out.update(flushes={str(n): v for n, v in flushes.items()},
               cpu_flush32_plans_equal=sum(cpu_equal),
               cpu_flush32_ms=cpu_ms, traced_flush8=traced,
               host_syncs_flush8=dict(enqueue=enqueue_syncs,
                                      read_back=read_syncs,
                                      one_copy_back=calibration),
               two_thread_resolve_equal=threads_agree)
    return sched, solo, out


def serving_hier_flush(sched, solo, small, full, limit, slice_res):
    """(b): the reference's batch (full catalog, the reference's limit)
    in one flush beside 7 serving requests (small catalog, as in (a))."""
    import bench_torch as bt
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics import HIER_SOLVES

    big = deployments(*LATER_HIER)
    clients = [bt._serving_pods(c) for c in range(7)]
    reqs = [dict(pods=big, provisioners=[provisioner(limit)],
                 instance_types=full)]
    reqs += [dict(pods=p, provisioners=[provisioner()],
                  instance_types=small) for p in clients]
    hier0 = sched.registry.counter(HIER_SOLVES).get({"path": "hierarchical"})
    names_from()
    kernels.reset_counts()
    results, wall_ms = _synced_ms(
        lambda: [h.result() for h in sched.submit_many(reqs)])
    launches = {k.name: k.launches for k in kernels.ALL}
    stats = dict(sched.hier_stats)
    check(sched.registry.counter(HIER_SOLVES).get({"path": "hierarchical"})
          == hier0 + 1, "the flush's reference request did not route "
          "hierarchically")
    check(launches["price_step_score"] >= 1
          and launches["price_step_score"] == stats["price_iters"],
          "price_step_score launches != price iterations in the flush")
    check(launches["packed_score"] == 0,
          "the flush launched the price-row entry")
    res = results[0]
    equal = plan(res) == plan(slice_res)
    tie = placements_tie(res, slice_res)
    check(equal or tie, "the flushed hierarchical plan differs from the "
          "slice phase's")
    serving_equal = [plan(r) == plan(s) for r, s in zip(results[1:], solo)]
    check(all(serving_equal), "a serving request beside the hierarchical "
          "one planned differently from its solo solve")
    return launches, dict(
        wall_ms=wall_ms, hier_total_ms=stats["total_ms"],
        price_iters=stats["price_iters"], launches=launches,
        nodes=len(res.nodes), cost=res.new_node_cost,
        infeasible=len(res.infeasible), plan_equal_slice=equal,
        placements_tie_slice=tie, serving_plans_equal_solo=sum(serving_equal))


def percentile(times, q):
    """The bench's percentile: the sorted sample at index int(q * (n-1))."""
    s = sorted(times)
    return s[int(q * (len(s) - 1))]


def serving_delta_unconstrained(catalog):
    """(c): the reference bench's ``measure_warmstart`` on the card."""
    import random

    import bench_torch as bt
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.models.tensorize import TensorizeCache, tensorize
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    provs = [provisioner()]
    pods = bt._warmstart_pods(SERVING["ws_pods"], "ws")
    solver = TpuSolver()
    cache = TensorizeCache()
    names_from()
    st, _ = cache.tensorize(pods, provs, catalog)
    cur, base_ms = _synced_ms(lambda: solver.solve(st).result)
    reg = Registry()
    rng = random.Random(7)
    live = [p.name for p in pods]
    times, modes, fell_back = [], {}, 0
    for k in range(SERVING["ws_steps"]):
        rm = rng.sample(live, SERVING["churn"])
        rms = set(rm)
        live = [n for n in live if n not in rms]
        add = bt._warmstart_pods(SERVING["churn"], f"wsc{k}")
        out = solver.solve_delta(
            cur, added=add, removed=rm, provisioners=provs,
            instance_types=catalog, tensorize_cache=cache, registry=reg)
        cur = out.result
        live += [p.name for p in add]
        if k > 0:  # step 0 pays the one-time chain-metadata build
            times.append(out.solve_ms)
        modes[out.mode] = modes.get(out.mode, 0) + 1
        fell_back += int(out.fell_back)
    all_pods = [p for n in list(cur.existing_nodes) + list(cur.nodes)
                for p in n.pods if p.name in cur.assignments]
    check(len(all_pods) == SERVING["ws_pods"] and not cur.infeasible,
          "the chain lost or left a pod")
    full, full_ms = _synced_ms(
        lambda: solver.solve(tensorize(all_pods, provs, catalog)).result)
    ratio = cur.new_node_cost / full.new_node_cost
    check(ratio <= 1.02, f"the chain's cost is {ratio} of a fresh solve's "
          f"(the contract is <= 1.02)")
    return dict(pods=SERVING["ws_pods"], churn=SERVING["churn"],
                steps=SERVING["ws_steps"], base_solve_ms=base_ms,
                p50_ms=percentile(times, 0.5), p99_ms=percentile(times, 0.99),
                max_ms=max(times), modes=modes, full_fallbacks=fell_back,
                cost=cur.new_node_cost, fresh_cost=full.new_node_cost,
                cost_ratio=ratio, fresh_solve_ms=full_ms,
                nodes=len(cur.nodes))


def constrained_chain(device, n_pods: int, steps: int, churn: int = 8):
    """``BatchScheduler.solve_delta`` on the device backend from an
    unconstrained base of ``n_pods``: each step removes ``churn`` pods
    (``random.Random(7)``) and adds one new zone-spread deployment of
    ``churn`` pods, whose displaced subproblem takes the scan tier.
    Returns (modes, final result, step walls ms, base wall ms)."""
    import random

    import bench_torch as bt
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    catalog = generate_catalog(full=False)
    provs = [provisioner()]
    sched = BatchScheduler(backend="tpu", device=device, registry=Registry())
    pods = bt._warmstart_pods(n_pods, "cs")
    names_from()
    cur, base_ms = _sync_any(device, lambda: sched.solve(
        pods, provs, catalog, relax=False))
    rng = random.Random(7)
    live = [p.name for p in pods]
    modes, walls = [], []
    for k in range(steps):
        rm = rng.sample(live, churn)
        rms = set(rm)
        live = [n for n in live if n not in rms]
        add = spread_deployment(f"sp{k}", churn)
        out, ms = _sync_any(device, lambda cur=cur, add=add, rm=rm:
                            sched.solve_delta(cur, added=add, removed=rm,
                                              provisioners=provs,
                                              instance_types=catalog))
        cur = out.result
        live += [p.name for p in add]
        modes.append(out.mode)
        walls.append(ms)
    return modes, cur, walls, base_ms


def _sync_any(device, fn):
    """(fn's value, wall ms), synchronising the card around it unless
    ``device`` is the host."""
    if str(device) == "cpu":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1000.0
    return _synced_ms(fn)


def check_seated(res, n_expected: int) -> None:
    """Every pod seated exactly once, or typed infeasible."""
    seated = [p.name for n in list(res.existing_nodes) + list(res.nodes)
              for p in n.pods]
    check(len(seated) == len(set(seated)), "a pod is seated twice")
    check(set(res.assignments) == set(seated),
          "the assignments and the seated pods differ")
    check(len(set(seated) | set(res.infeasible)) == n_expected,
          "a pod is neither seated nor typed infeasible")


def chain_snapshot(res):
    return (sorted((n.name, n.instance_type, n.zone,
                    tuple(sorted(p.name for p in n.pods)))
                   for n in list(res.existing_nodes) + list(res.nodes)),
            dict(res.assignments), dict(res.infeasible))


def serving_delta_constrained():
    """(d): the constrained chain on ``cuda`` and on ``cpu``."""
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        modes, res, walls, base_ms = constrained_chain(
            dev, SERVING["ws_pods"], SERVING["spread_steps"])
        check_seated(res, SERVING["ws_pods"])
        runs[dev] = (modes, chain_snapshot(res), walls, base_ms,
                     time.perf_counter() - t0)
    (mg, sg, wg, bg, tg), (mc, sc, _wc, bc, tc) = runs["cuda"], runs["cpu"]
    check(mg == mc, f"cuda and cpu chains took different modes: {mg} vs {mc}")
    check(sg == sc, "cuda and cpu chains ended in different plans")
    check("scan" in mg, f"the constrained chain never took the scan tier: "
          f"{mg}")
    return dict(pods=SERVING["ws_pods"], steps=SERVING["spread_steps"],
                modes={m: mg.count(m) for m in sorted(set(mg))},
                step_ms=wg, p50_ms=percentile(wg, 0.5),
                max_ms=max(wg), base_solve_ms=bg, cpu_base_solve_ms=bc,
                cuda_s=tg, cpu_s=tc, equal_on_cpu=True,
                nodes=len(sg[0]))


def phase_serving(limit, slice_res):
    """Phase 10: (a) megabatch flushes at the reference bench's width, (b)
    the reference's hierarchical request in a flush, (c) the bench's
    unconstrained delta chain, (d) a constrained delta chain on ``cuda``
    and ``cpu``."""
    from karpenter_tpu_torch.models.catalog import generate_catalog

    t_phase = time.perf_counter()
    small = generate_catalog(full=False)
    sched, solo, mega = serving_megabatch(small)
    SOLO_PLANS[:] = [plan(r) for r in solo]
    emit("serving_megabatch", **mega)
    with hier_at(LATER_HIER[0] * LATER_HIER[1]):
        launches, hier = serving_hier_flush(
            sched, solo, small, generate_catalog(full=True), limit,
            slice_res)
    emit("serving_hier_flush", **hier)
    del sched, solo
    emit("serving_delta", **serving_delta_unconstrained(small))
    emit("serving_delta_constrained", **serving_delta_constrained())
    check(not FAULTS.records, f"the port fell back: {FAULTS.records}")
    emit("serving", phase_s=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# the device guard's bookkeeping (every phase) and phase 11
# ---------------------------------------------------------------------------


#: (phase, budget s, wall s) of every guarded device call, and the
#: (registry, guard) of every ``BatchScheduler`` this run builds
GUARDED: list = []
SCHEDULERS: list = []
PHASE = ["startup"]


def install_guard_watch() -> None:
    """Time every guarded device call against its budget, and keep each
    scheduler's registry and guard, so each phase can be read for hangs,
    degraded solves and the margin of its guarded calls."""
    from karpenter_tpu_torch.solver import guard, scheduler

    init = scheduler.BatchScheduler.__init__
    run = guard.DeviceGuard._run

    def tracked(self, *a, **kw):
        init(self, *a, **kw)
        SCHEDULERS.append((self.registry, self._guard))

    def timed(self, timeout_s, fn, args, kwargs):
        t0 = time.perf_counter()
        try:
            return run(self, timeout_s, fn, args, kwargs)
        finally:
            if self.enabled and timeout_s > 0:
                GUARDED.append((PHASE[0], timeout_s,
                                time.perf_counter() - t0))

    scheduler.BatchScheduler.__init__ = tracked
    guard.DeviceGuard._run = timed


def guard_clean(after: str) -> None:
    """After a phase: no hang counted, no solve degraded and every guard
    healthy on every scheduler built so far, no warning trapped; prints
    the phase's guarded calls against their budgets."""
    from karpenter_tpu_torch import metrics

    regs = {id(r): r for r, _g in SCHEDULERS}
    regs[id(metrics.registry)] = metrics.registry
    degraded = sum(sum(r.counter(metrics.SOLVER_DEGRADED_SOLVES)
                       .values.values()) for r in regs.values())
    hangs = sum(r.counter(metrics.SOLVER_DEVICE_HANGS).get()
                for r in regs.values())
    unhealthy = sum(1 for _r, g in SCHEDULERS if not g.healthy)
    routed = sum(host_routed(r) for r in regs.values())
    check(degraded == 0 and hangs == 0 and unhealthy == 0,
          f"after {after}: {hangs} device hangs, {degraded} degraded "
          f"solves, {unhealthy} unhealthy guards")
    check(routed == 0, f"after {after}: {routed} solves host-routed by "
          "admission")
    check(not FAULTS.records, f"the port fell back: {FAULTS.records}")
    calls = [(b, w) for ph, b, w in GUARDED if ph == after]
    worst = max(calls, key=lambda c: c[1] / c[0]) if calls else None
    emit("guard", after=after, schedulers=len(SCHEDULERS),
         degraded_solves=degraded, device_hangs=hangs, host_routed=routed,
         guarded_calls=len(calls),
         max_wall_s=worst[1] if worst else None,
         its_budget_s=worst[0] if worst else None,
         min_margin_s=min((b - w for b, w in calls), default=None))


#: phase 11's sizes: the reference's 10 x 2,500 pods plus 32 gangs of 16
#: members (``bench_torch._gang_member``), and 1 paired latency sample
#: for (b)'s ``measure_gang`` (the bench runs 9; cut to 3 when phase 16(c)
#: came in and to 1 when phase 17 did, since each pair takes about 11 s
#: on the card)
GANGS = {"gangs": 32, "size": 16, "bench_pairs": 1}


def gang_batch(nd: int, per: int, n_gangs: int, size: int = 16,
               tag: str = "h"):
    """``deployments(nd, per)`` plus ``n_gangs`` gangs of ``size``, one gang
    doomed by a member pinned to ``zone-none``, and one short roster (3/4
    of its declared members).  Returns (pods, {gang id: members})."""
    import bench_torch as bt

    gangs = {f"train{g}": [bt._gang_member(f"train{g}", i, size)
                           for i in range(size)] for g in range(n_gangs)}
    doomed = [bt._gang_member("doomed", i, size) for i in range(size)]
    doomed[size // 2] = bt._gang_member("doomed", size // 2, size,
                                       sel={ZONE: "zone-none"})
    gangs["doomed"] = doomed
    gangs["short"] = [bt._gang_member("short", i, size)
                      for i in range(size * 3 // 4)]
    pods = deployments(nd, per, tag)
    for members in gangs.values():
        pods += members
    return pods, gangs


def gang_audit(res, gangs) -> dict:
    """All-or-nothing over ``gangs``: a partial gang is a violation, a
    retracted member without the typed reason is untyped."""
    from karpenter_tpu_torch.gang import is_gang_reason

    out = dict(placed=[], retracted=[], violations=0, untyped=0)
    for gid, members in gangs.items():
        seated = [p for p in members if p.name in res.assignments]
        if seated and len(seated) != len(members):
            out["violations"] += 1
        elif seated:
            out["placed"].append(gid)
        else:
            out["retracted"].append(gid)
            if not all(is_gang_reason(res.infeasible.get(p.name, ""))
                       for p in members):
                out["untyped"] += 1
    return out


def gang_hier_100k():
    """(a): the reference's 25,000 pods plus the gangs, limited (at 99% of
    this batch's own buy, as the slice), through
    ``BatchScheduler(backend="auto")`` on the card, from names at 1000 (a
    plan depends on the node-name counter through coalescing's order)."""
    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=True)
    pods, gangs = gang_batch(*LATER_HIER, GANGS["gangs"], GANGS["size"])
    names_from()
    t0 = time.perf_counter()
    with hier_at(len(pods)):
        (_sched, st, limit, free, res, stats, wall_ms, launches,
         shipped) = limited_solve(None, pods, catalog)
    check(launches["price_step_score"] >= 1
          and launches["price_step_score"] == stats["price_iters"],
          "gang-hier-100k: price_step_score launches != price iterations")
    check(launches["packed_score"] == 0,
          "gang-hier-100k launched the price-row entry")
    audit = gang_audit(res, gangs)
    check(audit["violations"] == 0 and audit["untyped"] == 0,
          f"gang-hier-100k: {audit['violations']} partial gangs, "
          f"{audit['untyped']} untyped retractions")
    check({"doomed", "short"} <= set(audit["retracted"]),
          "gang-hier-100k: a doomed gang was not retracted")
    n_train = sum(1 for g in audit["placed"] + audit["retracted"]
                  if g.startswith("train"))
    check(n_train == GANGS["gangs"], "a training gang was neither placed "
          "nor retracted")
    return launches, dict(
        pods=len(pods), gangs=len(gangs), groups=st.G,
        blocks=stats["blocks"], price_iters=stats["price_iters"],
        wall_ms=wall_ms, tensorize_ms=stats["tensorize_ms"],
        partition_ms=stats["partition_ms"], entries_ms=stats["entries_ms"],
        wave_ms=stats["wave_ms"], score_ms=stats["score_ms"],
        repair_ms=stats["repair_ms"], repair_pods=stats["repair_pods"],
        hier_total_ms=stats["total_ms"], gang_epilogue_ms=stats["gang_ms"],
        gang_outcomes=stats["gang_outcomes"],
        trains_placed=sum(g.startswith("train") for g in audit["placed"]),
        trains_retracted=sum(g.startswith("train")
                             for g in audit["retracted"]),
        retracted=audit["retracted"], atomicity_violations=0,
        nodes=len(res.nodes), cost=res.new_node_cost,
        infeasible=len(res.infeasible), cpu_limit=limit,
        cpu_shipped=shipped, free_nodes=len(free.nodes),
        launches=launches, phase_s=time.perf_counter() - t0)


def gang_hier_parity(nd: int = 8, per: int = 250, n_gangs: int = 4):
    """(b): a small gang-bearing hierarchical batch with a binding limit on
    ``cuda`` and on ``cpu``: the plans must agree."""
    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=True)
    pods, gangs = gang_batch(nd, per, n_gangs, tag="gp")
    runs = {}
    with hier_at(len(pods)):
        for dev in ("cuda", "cpu"):
            names_from()
            t0 = time.perf_counter()
            (_s, _st, limit, _free, res, stats, _w, _l,
             _shipped) = limited_solve(dev, pods, catalog)
            runs[dev] = (limit, res, stats, time.perf_counter() - t0)
    (lg, rg, sg, tg), (lc, rc, _sc, tc) = runs["cuda"], runs["cpu"]
    audits = [gang_audit(r, gangs) for r in (rg, rc)]
    check(all(a["violations"] == 0 and a["untyped"] == 0 for a in audits),
          "gang parity batch: a partial or untyped gang")
    equal = plan(rg) == plan(rc)
    tie = placements_tie(rg, rc)
    check(lg == lc and (equal or tie)
          and rg.infeasible == rc.infeasible,
          "gang parity batch: cuda and cpu disagree")
    return dict(pods=len(pods), gangs=len(gangs), cpu_limit=lg,
                plans_equal=equal, placements_tie=tie,
                retracted=audits[0]["retracted"],
                price_iters=sg["price_iters"], seconds=[tg, tc])


def degraded_batch():
    """``TestSchedulerDegradation``'s batch: 300 pods of 0.5 cpu, above the
    256-pod oracle route."""
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.pod import PodSpec

    pods = [PodSpec(name=f"p{i}", requests={"cpu": 0.5}, owner_key="d")
            for i in range(300)]
    return pods, [provisioner()], generate_catalog(full=False)


def injected_hang() -> dict:
    """(c)1: ``KT_FAULTS="device_hang@fence:at=1"`` set only while a fresh
    ``auto`` scheduler is built: its first solve hangs at the read-back,
    is served by a host tier, and after the probe answers the card serves
    the batch again as an unfaulted scheduler does."""
    from karpenter_tpu_torch import metrics
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    pods, provs, catalog = degraded_batch()
    reg = Registry()
    injected0 = metrics.registry.counter(metrics.FAULTS_INJECTED).get(
        {"kind": "device_hang", "site": "fence"})
    os.environ["KT_FAULTS"] = "device_hang@fence:at=1"
    try:
        sched = BatchScheduler(backend="auto", registry=reg)
    finally:
        os.environ.pop("KT_FAULTS", None)
    sched._guard.probe_interval_s = 0.25
    # the probe answers only once the latch is read: the host tier's serve
    # can outlast the 0.25 s interval, and a recovery before the read
    # would hide the latch
    probe, latch_read = sched._guard.probe_fn, threading.Event()

    def held_probe():
        latch_read.wait(60.0)
        probe()

    sched._guard.probe_fn = held_probe
    names_from()
    t0 = time.perf_counter()
    res = sched.solve(pods, provs, catalog)
    degraded_ms = (time.perf_counter() - t0) * 1000.0
    injected = metrics.registry.counter(metrics.FAULTS_INJECTED).get(
        {"kind": "device_hang", "site": "fence"}) - injected0
    hangs = reg.counter(metrics.SOLVER_DEVICE_HANGS).get()
    healthy_after = reg.gauge(metrics.SOLVER_DEVICE_HEALTHY).get()
    latch_read.set()
    degraded = {dict(k)["backend"]: v for k, v in
                reg.counter(metrics.SOLVER_DEGRADED_SOLVES).values.items()}
    check(len(res.assignments) == len(pods) and not res.infeasible,
          "the degraded serve left pods unseated")
    check(hangs == 1 and healthy_after == 0 and injected == 1
          and sum(degraded.values()) == 1,
          f"injected hang: hangs {hangs}, healthy {healthy_after}, "
          f"injected {injected}, degraded {degraded}")
    tier = next(b for b, v in degraded.items() if v == 1)
    deadline = time.perf_counter() + 60.0
    while not sched._guard.healthy and time.perf_counter() < deadline:
        time.sleep(0.01)
    recovery_s = time.perf_counter() - t0
    check(sched._guard.healthy and reg.gauge(
        metrics.SOLVER_DEVICE_HEALTHY).get() == 1,
        "the probe did not recover the device tier")
    names_from()
    again = sched.solve(pods, provs, catalog)
    names_from()
    clean = BatchScheduler(backend="auto", registry=Registry()).solve(
        pods, provs, catalog)
    check(sum(reg.counter(metrics.SOLVER_DEGRADED_SOLVES).values.values())
          == 1, "the recovered solve was served by a host tier")
    check(plan(again) == plan(clean)
          and again.assignments == clean.assignments,
          "the recovered solve differs from an unfaulted cuda solve")
    sched.stop_warms()
    return dict(degraded_tier=tier, degraded_ms=degraded_ms,
                degraded_nodes=len(res.nodes),
                degraded_cost=res.new_node_cost, device_hangs=hangs,
                healthy_after_hang=healthy_after, injected=injected,
                hang_to_recovery_s=recovery_s,
                recovered_nodes=len(again.nodes),
                recovered_cost=again.new_node_cost,
                recovered_equals_unfaulted=True)


def real_stall(stall_s: float = 5.0, timeout_s: float = 2.0) -> dict:
    """(c)2: a guard on ``cuda`` with a short deadline runs a call that
    spins the card for ``stall_s`` and then reads back: it must raise
    ``DeviceHang``, latch unhealthy, and turn healthy only after the
    stall drained (the probe is an op on the same card)."""
    import torch

    from karpenter_tpu_torch.solver.guard import DeviceGuard, DeviceHang

    # cycles per second of torch.cuda._sleep, from a short calibration
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    torch.cuda._sleep(100_000_000)
    b.record()
    torch.cuda.synchronize()
    cycles_per_s = 100_000_000 / (a.elapsed_time(b) / 1000.0)
    events = []
    done = {}

    def spin():
        torch.cuda._sleep(int(cycles_per_s * stall_s))
        torch.zeros(1, device="cuda").sum().item()
        done["t"] = time.perf_counter()

    g = DeviceGuard(timeout_s=timeout_s, probe_interval_s=0.1,
                    device="cuda",
                    on_health_change=lambda h: events.append(
                        (h, time.perf_counter())))
    t0 = time.perf_counter()
    try:
        g.run(spin)
        raised = False
    except DeviceHang:
        raised = True
    raised_s = time.perf_counter() - t0
    latched = not g.healthy
    deadline = time.perf_counter() + 60.0
    while not g.healthy and time.perf_counter() < deadline:
        time.sleep(0.01)
    g.stop()
    torch.cuda.synchronize()
    healthy_at = next((t for h, t in events if h), None)
    check(raised and latched and healthy_at is not None
          and "t" in done,
          f"real stall: raised {raised}, latched {latched}, "
          f"recovered {healthy_at is not None}")
    check(healthy_at >= done["t"] - 0.05,
          "the probe answered before the stall drained")
    return dict(stall_s=stall_s, timeout_s=timeout_s, raised_after_s=raised_s,
                stall_drained_s=done["t"] - t0,
                healthy_after_s=healthy_at - t0,
                events=[h for h, _t in events])


def native_tier(catalog_small) -> dict:
    """(d): the native tier's build on this machine, ``backend="native"``
    on the 300-pod batch, and ``TestAutoBackendE2E``'s path through
    ``ProvisioningController``."""
    from karpenter_tpu_torch.cloud.fake import FakeCloudProvider
    from karpenter_tpu_torch.controllers.provisioning import (
        ProvisioningController,
    )
    from karpenter_tpu_torch.controllers.state import ClusterState
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.solver import native
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.utils.clock import FakeClock

    t0 = time.perf_counter()
    ok = native.available()
    load_s = time.perf_counter() - t0
    check(ok, "the native tier did not build")
    pods, provs, catalog = degraded_batch()
    sched = BatchScheduler(backend="native")
    sched.solve(pods, provs, catalog)
    t1 = time.perf_counter()
    res = sched.solve(pods, provs, catalog)
    solve_ms = (time.perf_counter() - t1) * 1000.0
    check(len(res.assignments) == len(pods) and not res.infeasible,
          "backend=native left pods unseated")
    clock = FakeClock()
    state = ClusterState(clock=clock)
    cloud = FakeCloudProvider(catalog_small, clock=clock)
    ctrl = ProvisioningController(
        state, cloud, scheduler=BatchScheduler(backend="auto"), clock=clock)
    state.apply_provisioner(provisioner())
    for i in range(20):
        state.add_pod(PodSpec(name=f"p{i}", requests={"cpu": 1.0},
                              owner_key="d"))
    ctrl.reconcile()
    clock.advance(1.5)
    e2e = ctrl.reconcile()
    check(e2e is not None and not state.pending_pods()
          and all(p in state.bindings for p in state.pods),
          "the auto backend end to end left pods pending")
    return dict(available=ok, version=native.version(),
                build_s=native.build_s, load_s=load_s,
                native_solve_ms=solve_ms, native_nodes=len(res.nodes),
                native_cost=res.new_node_cost,
                auto_e2e_nodes=len(state.nodes))


def phase_gangs():
    """Phase 11: (a) gang-hier-100k, (b) the gang bench and the gang
    parity batch, (c) an injected and a real device hang, (d) the native
    tier.  Returns (a)'s kernel launches."""
    import bench_torch as bt
    from karpenter_tpu_torch.models.catalog import generate_catalog

    t_phase = time.perf_counter()
    PHASE[0] = "gangs"
    launches, hier = gang_hier_100k()
    emit("gangs_hier_100k", **hier)
    t0 = time.perf_counter()
    bench = bt.measure_gang(pairs=GANGS["bench_pairs"])
    check(bench["gang_atomicity_violations"] == 0
          and bench["gang_retracted_untyped"] == 0,
          "gang bench: a partial or untyped gang")
    check(bench["gang_spread_packed_zones"] < bench["gang_spread_naive_zones"]
          and bench["gang_pack_whole"], "gang bench: packing did not pack")
    emit("gangs_bench", **bench, seconds=time.perf_counter() - t0)
    emit("gangs_parity", **gang_hier_parity())
    emit("gangs_native", **native_tier(generate_catalog(full=False)))
    guard_clean("gangs")
    # (c): the one part of the run where hangs, degraded solves and the
    # guard's warnings are expected; its schedulers leave the watch after
    PHASE[0] = "hang"
    n_sched, n_faults = len(SCHEDULERS), len(FAULTS.records)
    hang = injected_hang()
    stall = real_stall()
    expected = FAULTS.records[n_faults:]
    check(all("device tier UNHEALTHY" in r or "flight recorder dump" in r
              for r in expected), f"unexpected warnings: {expected}")
    del FAULTS.records[n_faults:]
    del SCHEDULERS[n_sched:]
    calls = [(b, w) for ph, b, w in GUARDED if ph == "hang"]
    emit("gangs_hang", injected=hang, real_stall=stall,
         trapped_warnings=len(expected), guarded_calls=len(calls),
         phase_s=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# phase 12: the solver sidecar (SolvePipeline, admission, SolverService)
# ---------------------------------------------------------------------------


#: phase 12's sizes: the reference bench's ``measure_throughput`` (32
#: clients, 8 slots) and ``measure_overload`` (2 critical and 8
#: best_effort clients of 200 pods), each window 1 s (the bench's 4 s, cut
#: to 2 s when phase 17 came in and to 1 s when phase 18 did)
SERVICE = {"clients": 32, "seconds": 1.0, "max_slots": 8,
           "concurrency": (1, 8, 32), "critical": 2, "best_effort": 8,
           "overload_pods": 200, "hier_knob_pods": (10, 2500),
           "wire_trace_budget_s": 300.0}
#: phase 10(a)'s reference plans of the 32 serving requests (the solo
#: plans, then the 32-flush's), reused by 12(a) and 15(c)
SOLO_PLANS: list = []


def host_routed(registry) -> float:
    from karpenter_tpu_torch.metrics import ADMISSION_HOST_ROUTED

    return sum(registry.counter(ADMISSION_HOST_ROUTED).values.values())


def service_pipeline(catalog) -> dict:
    """(a): the reference bench's ``measure_throughput`` through the port's
    ``SolvePipeline`` on ``backend="tpu"``: concurrency 1 on a 1-slot
    pipeline (the serial baseline), then 1, 8 and 32 on an 8-slot one,
    after warming the request's shape and its slot rungs.  Every tenant's
    last served plan against its solo plan."""
    import bench_torch as bt
    from karpenter_tpu_torch.metrics import MEGABATCH_SLOTS, Registry
    from karpenter_tpu_torch.service.server import SolvePipeline
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    provs = [provisioner()]
    clients = [bt._serving_pods(c) for c in range(SERVICE["clients"])]
    reg = Registry()
    sched = BatchScheduler(backend="tpu", registry=reg)
    st, _ = sched._tensorize_cache.tensorize(clients[0], provs, catalog)
    t0 = time.perf_counter()
    rung, rungs = 2, [None]
    while rung <= SERVICE["max_slots"]:
        rungs.append(rung)
        rung *= 2
    warms = [sched._tpu.warm_async(st, on_done=sched._warm_done, slots=s)
             for s in rungs]
    while not sched._tpu.warm_idle():
        time.sleep(0.05)
    warm_s = time.perf_counter() - t0
    check(all(warms), "the service warms did not run")
    solo = SOLO_PLANS or [plan(sched.solve(p, provs, catalog, relax=False))
                          for p in clients]
    h = reg.histogram(MEGABATCH_SLOTS)

    def kwargs_of(ci):
        return dict(pods=clients[ci], provisioners=provs,
                    instance_types=catalog)

    def run(concurrency, slots):
        pipe = SolvePipeline(sched, registry=reg, max_slots=slots,
                             admission=False)
        try:
            occ0 = (sum(h.sums.values()), sum(h.totals.values()))
            names_from(100_000)
            counts, last, lat, _s, wall = bt.closed_loop(
                pipe, kwargs_of, concurrency, SERVICE["seconds"])
            d_sum = sum(h.sums.values()) - occ0[0]
            d_n = sum(h.totals.values()) - occ0[1]
        finally:
            pipe.stop()
        equal = [plan(r) == solo[ci] for ci, r in enumerate(last)
                 if r is not None]
        check(all(equal), f"a served plan at concurrency {concurrency} "
              f"differs from its solo plan ({equal.count(False)})")
        return dict(solves=sum(counts), solves_per_s=sum(counts) / wall,
                    wall_s=wall, p50_ms=percentile(lat, 0.5) * 1e3,
                    p99_ms=percentile(lat, 0.99) * 1e3,
                    slot_occupancy_mean=(d_sum / d_n) if d_n else None,
                    plans_equal_solo=sum(equal))

    out = {"c1_serial": run(1, 1), "c1": run(1, SERVICE["max_slots"])}
    for c in SERVICE["concurrency"][1:]:
        out[f"c{c}"] = run(c, SERVICE["max_slots"])
    top = f"c{SERVICE['concurrency'][-1]}"
    c1, c32 = out["c1_serial"]["solves_per_s"], out[top]["solves_per_s"]
    check(c32 > c1, f"{top} {c32} solves/s does not beat c1 {c1}")
    ratio = (1.0 / out["c1"]["solves_per_s"]) / (1.0 / c1)
    sched.stop_warms()
    return dict(requests=len(clients), pods_per_request=len(clients[0]),
                max_slots=SERVICE["max_slots"], seconds=SERVICE["seconds"],
                warm_s=warm_s, **out, megabatch_speedup=c32 / c1,
                single_latency_ratio=ratio, solo_reused=bool(SOLO_PLANS),
                host_routed=host_routed(reg))


def service_overload(catalog) -> dict:
    """(b): the reference bench's ``measure_overload`` shape on
    ``backend="tpu"``: the unloaded critical baseline (2 clients, half the
    time), then 2 critical and 8 best_effort closed-loop clients against a
    tight admission queue (best_effort depth 3, total 6).  The reference's
    brownout and breaker settings are kept."""
    import bench_torch as bt
    from karpenter_tpu_torch.admission import (
        BEST_EFFORT,
        CRITICAL,
        AdmissionControl,
        AdmissionPolicy,
        ClassQuota,
    )
    from karpenter_tpu_torch.admission.__main__ import (
        _percentile as admission_percentile,
    )
    from karpenter_tpu_torch.metrics import ADMISSION_SHED, Registry
    from karpenter_tpu_torch.service.server import SolvePipeline
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    provs = [provisioner()]
    n = SERVICE["overload_pods"]
    batches = {ci: bt._overload_pods(ci, n)
               for ci in list(range(SERVICE["critical"]))
               + [100 + i for i in range(SERVICE["best_effort"])]}
    reg = Registry()
    sched = BatchScheduler(backend="tpu", registry=reg)
    for ci in (0, 100):  # the shapes' first solves off the record
        sched.solve(batches[ci], provs, catalog)

    def kwargs_of(ci):
        return dict(pods=batches[ci], provisioners=provs,
                    instance_types=catalog)

    pipe = SolvePipeline(sched, registry=reg, admission=AdmissionControl(
        policy=AdmissionPolicy(), registry=reg))
    try:
        _c, _l, base_lat, base_sheds, _w = bt.closed_loop(
            pipe, kwargs_of, SERVICE["critical"], SERVICE["seconds"] / 2,
            pclass=CRITICAL)
    finally:
        pipe.stop()
    # the bench's bounds at its 4x overdrive: best_effort depth 3, total 6
    policy = AdmissionPolicy(
        quotas={BEST_EFFORT: ClassQuota(max_queue_depth=3)},
        max_queue_total=6)
    adm = AdmissionControl(policy=policy, registry=reg)
    pipe = SolvePipeline(sched, registry=reg, admission=adm)
    import threading

    res = {}

    def run(pclass, ids, deadline_s):
        res[pclass] = bt.closed_loop(
            pipe, lambda ci: kwargs_of(ids[ci]), len(ids),
            SERVICE["seconds"], pclass=pclass, deadline_s=deadline_s)

    shed0 = dict(reg.counter(ADMISSION_SHED).values)
    try:
        threads = [
            threading.Thread(target=run, args=(
                CRITICAL, list(range(SERVICE["critical"])), 30.0)),
            threading.Thread(target=run, args=(
                BEST_EFFORT,
                [100 + i for i in range(SERVICE["best_effort"])], 2.0))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = adm.stats()
    finally:
        pipe.stop()
    shed_by = {}
    for k, v in reg.counter(ADMISSION_SHED).values.items():
        d = v - shed0.get(k, 0.0)
        if d:
            lab = dict(k)
            shed_by[f"{lab['class']}/{lab['reason']}"] = d
    crit_lat, be_lat = res[CRITICAL][2], res[BEST_EFFORT][2]
    crit_sheds, be_sheds = len(res[CRITICAL][3]), len(res[BEST_EFFORT][3])
    unloaded_p99 = admission_percentile(base_lat, 0.99) * 1e3
    crit_p99 = admission_percentile(crit_lat, 0.99) * 1e3
    check(crit_sheds == 0, f"{crit_sheds} critical requests were shed")
    check(be_sheds > 0, "no best_effort request was shed: admission "
          "never engaged")
    return dict(
        pods_per_request=n, critical_clients=SERVICE["critical"],
        best_effort_clients=SERVICE["best_effort"],
        seconds=SERVICE["seconds"],
        unloaded_critical_p99_ms=unloaded_p99,
        unloaded_critical_served=len(base_lat),
        unloaded_critical_sheds=len(base_sheds),
        critical_p50_ms=admission_percentile(crit_lat, 0.5) * 1e3,
        critical_p99_ms=crit_p99,
        critical_p99_ratio=(crit_p99 / unloaded_p99) if unloaded_p99
        else None, critical_p99_budget_ratio=2.0,
        critical_served=len(crit_lat), critical_sheds=crit_sheds,
        best_effort_p50_ms=admission_percentile(be_lat, 0.5) * 1e3,
        best_effort_p99_ms=admission_percentile(be_lat, 0.99) * 1e3,
        best_effort_served=len(be_lat), best_effort_sheds=be_sheds,
        shed_by_reason=shed_by, breaker=stats["breaker"],
        brownout_level=stats["brownout_level"],
        queue_delay_ewma_ms=stats["queue_delay_ewma_ms"],
        host_routed=host_routed(reg))


def service_wire(full, limit, slice_res):
    """(c): the reference's limited batch as one ``Solve`` RPC to
    the port's ``make_server(SolverService(...))`` on a unix socket, from
    a raw ``grpc`` unary stub with the server's 256 MiB message limits.
    The decoded plan against phase ``slice``'s.  Returns (launches, the
    phase's fields)."""
    import tempfile

    import grpc

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics import HIER_SOLVES, Registry
    from karpenter_tpu_torch.obs import FlightRecorder, Tracer
    from karpenter_tpu_torch.service import codec
    from karpenter_tpu_torch.service import solver_pb2 as pb
    from karpenter_tpu_torch.service.server import (
        SERVICE as RPC_SERVICE,
        SolverService,
        make_server,
    )
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    pods = deployments(*LATER_HIER)
    reg = Registry()
    # the per-RPC trace's anomaly budget: the reference's 30 s default is
    # sized for a sidecar's usual requests, and this one request runs
    # 23-42 s on the card (PERF.md), so a 30 s budget dumps on a run-to-run
    # spread; 300 s still flags a wedged request
    tracer = Tracer(registry=reg, flight=FlightRecorder(
        registry=reg, slow_trace_s=SERVICE["wire_trace_budget_s"]))
    sched = BatchScheduler(backend="auto", registry=reg, tracer=tracer)
    service = SolverService(sched, registry=reg)
    sock_dir = tempfile.mkdtemp(prefix="kt-smoke-")
    address = f"unix:{sock_dir}/solver.sock"
    server, _port = make_server(service, host=address)
    limits = [("grpc.max_receive_message_length", 256 * 1024 * 1024),
              ("grpc.max_send_message_length", 256 * 1024 * 1024)]
    channel = grpc.insecure_channel(address, options=limits)
    try:
        solve = channel.unary_unary(
            f"/{RPC_SERVICE}/Solve",
            request_serializer=pb.SolveRequest.SerializeToString,
            response_deserializer=pb.SolveResponse.FromString)
        t0 = time.perf_counter()
        req = codec.encode_request(pods, [provisioner(limit)], full)
        encode_ms = (time.perf_counter() - t0) * 1000.0
        request_bytes = req.ByteSize()
        hier0 = reg.counter(HIER_SOLVES).get({"path": "hierarchical"})
        names_from()
        kernels.reset_counts()
        t0 = time.perf_counter()
        resp = solve(req, timeout=900.0)
        rpc_ms = (time.perf_counter() - t0) * 1000.0
        launches = {k.name: k.launches for k in kernels.ALL}
        t0 = time.perf_counter()
        res = codec.decode_response(resp)
        decode_ms = (time.perf_counter() - t0) * 1000.0
    finally:
        channel.close()
        server.stop(0)
        service.close()
        sched.stop_warms()
    stats = dict(sched.hier_stats)
    check(reg.counter(HIER_SOLVES).get({"path": "hierarchical"})
          == hier0 + 1, "the wire request did not route hierarchically")
    check(launches["price_step_score"] >= 1
          and launches["price_step_score"] == stats["price_iters"],
          "price_step_score launches != price iterations over the wire")
    check(launches["packed_score"] == 0,
          "the wire request launched the price-row entry")
    equal = plan(res) == plan(slice_res)
    tie = placements_tie(res, slice_res)
    check(equal or tie, "the plan over the wire differs from the slice "
          "phase's")
    return launches, dict(
        pods=len(pods), request_bytes=request_bytes,
        response_bytes=resp.ByteSize(), encode_ms=encode_ms,
        rpc_wall_ms=rpc_ms, solve_ms=resp.solve_ms, decode_ms=decode_ms,
        hier_total_ms=stats["total_ms"], price_iters=stats["price_iters"],
        launches=launches, nodes=len(res.nodes), cost=res.new_node_cost,
        infeasible=len(res.infeasible), replica_id=resp.replica_id,
        plan_equal_slice=equal, placements_tie_slice=tie,
        trace_budget_s=SERVICE["wire_trace_budget_s"],
        host_routed=host_routed(reg))


def service_breaker_hang(small, full) -> dict:
    """(d): ``KT_FAULTS="device_hang@fence:at=1"`` set while a fresh
    ``auto`` scheduler is built; a pipeline over it with admission on.
    The hang opens the breaker, requests are host-routed while it is not
    closed, the guard's probe recovers the card, half-open probes pass and
    the breaker closes.  Then the ``hier_threshold`` knob is moved at
    runtime and a batch at the new threshold routes hierarchically."""
    from karpenter_tpu_torch import metrics
    from karpenter_tpu_torch.admission import (
        AdmissionControl,
        AdmissionPolicy,
        CircuitBreaker,
    )
    from karpenter_tpu_torch.metrics import (
        ADMISSION_BREAKER_TRANSITIONS,
        HIER_SOLVES,
        Registry,
    )
    from karpenter_tpu_torch.service.server import SolvePipeline
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.tuning import global_knobs

    pods, provs, _catalog = degraded_batch()
    reg = Registry()
    os.environ["KT_FAULTS"] = "device_hang@fence:at=1"
    try:
        sched = BatchScheduler(backend="auto", registry=reg)
    finally:
        os.environ.pop("KT_FAULTS", None)
    sched._guard.probe_interval_s = 0.25
    transitions = []
    t_start = time.perf_counter()
    breaker = CircuitBreaker(
        open_interval_s=1.0, recovery_window_s=0.5, registry=reg,
        on_transition=lambda to: transitions.append(
            (to, time.perf_counter() - t_start)))
    pipe = SolvePipeline(sched, registry=reg, admission=AdmissionControl(
        policy=AdmissionPolicy(), registry=reg, breaker=breaker))
    served = []
    try:
        kwargs = dict(pods=pods, provisioners=provs, instance_types=small)
        first = pipe.solve(dict(kwargs))
        check(len(first.assignments) == len(pods) and not first.infeasible,
              "the hung request left pods unseated")
        t_hang = time.perf_counter() - t_start
        deadline = time.perf_counter() + 60.0
        while breaker.state != "closed" or not transitions:
            check(time.perf_counter() < deadline,
                  f"the breaker did not close: {transitions}")
            res = pipe.solve(dict(kwargs))
            check(len(res.assignments) == len(pods),
                  "a request during the breaker cycle left pods unseated")
            served.append(res)
            time.sleep(0.05)
        t_closed = time.perf_counter() - t_start
        routed = host_routed(reg)
        # the knob registry at runtime: hier_threshold is lattice-bound
        knobs = global_knobs()
        off_lattice = knobs.set("hier_threshold", 2000)
        nd, per = SERVICE["hier_knob_pods"]
        big = deployments(nd, per, tag="k")
        hier0 = reg.counter(HIER_SOLVES).get({"path": "hierarchical"})
        check(knobs.set("hier_threshold", nd * per),
              "the hier_threshold knob refused a lattice value")
        try:
            t0 = time.perf_counter()
            knob_res = pipe.solve(dict(pods=big, provisioners=provs,
                                       instance_types=full))
            knob_ms = (time.perf_counter() - t0) * 1000.0
        finally:
            knobs.reset("hier_threshold")
        routed_hier = (reg.counter(HIER_SOLVES).get(
            {"path": "hierarchical"}) - hier0)
        check(routed_hier == 1, "the knob-moved batch did not route "
              "hierarchically")
        check(not knob_res.infeasible, "the knob-moved batch left pods "
              "infeasible")
    finally:
        pipe.stop()
        sched.stop_warms()
    seq = [to for to, _t in transitions]
    check(seq[:1] == ["open"] and seq[-1:] == ["closed"]
          and "half_open" in seq,
          f"breaker transitions {seq}")
    check(routed > 0, "no request was host-routed while the breaker was "
          "open")
    return dict(
        open_interval_s=breaker.open_interval_s,
        recovery_window_s=breaker.recovery_window_s,
        probe_interval_s=sched._guard.probe_interval_s,
        transitions=transitions,
        transitions_counted={dict(k)["to"]: v for k, v in reg.counter(
            ADMISSION_BREAKER_TRANSITIONS).values.items()},
        device_hangs=reg.counter(metrics.SOLVER_DEVICE_HANGS).get(),
        degraded_solves=sum(reg.counter(
            metrics.SOLVER_DEGRADED_SOLVES).values.values()),
        requests_served=1 + len(served), host_routed=routed,
        hung_request_s=t_hang, open_to_closed_s=(
            transitions[-1][1] - transitions[0][1]),
        start_to_closed_s=t_closed,
        knob_off_lattice_2000_accepted=off_lattice,
        knob_hier_threshold=nd * per, knob_batch_pods=len(big),
        knob_batch_ms=knob_ms, knob_hier_routed=routed_hier,
        knob_batch_nodes=len(knob_res.nodes),
        hier_threshold_after=knobs.get("hier_threshold"))


def phase_service(limit, slice_res):
    """Phase 12: (a) closed-loop serving through ``SolvePipeline``, (b) the
    4x overdrive with admission, (c) the reference's batch over gRPC, then,
    after the guard check, (d) an injected hang through the breaker and a
    runtime knob move.  Returns (c)'s kernel launches."""
    from karpenter_tpu_torch.models.catalog import generate_catalog

    t_phase = time.perf_counter()
    PHASE[0] = "service"
    small, full = generate_catalog(full=False), generate_catalog(full=True)
    emit("service_pipeline", **service_pipeline(small))
    emit("service_overload", **service_overload(small))
    with hier_at(LATER_HIER[0] * LATER_HIER[1]):
        launches, wire = service_wire(full, limit, slice_res)
    emit("service_wire", **wire)
    guard_clean("service")
    # (d): hangs, degraded solves, host routing and the guard's warnings
    # are expected here; its schedulers leave the watch after
    PHASE[0] = "service_hang"
    n_sched, n_faults = len(SCHEDULERS), len(FAULTS.records)
    hang = service_breaker_hang(small, full)
    expected = FAULTS.records[n_faults:]
    check(all("device tier UNHEALTHY" in r or "flight recorder dump" in r
              or "device-path circuit breaker" in r for r in expected),
          f"unexpected warnings: {expected}")
    del FAULTS.records[n_faults:]
    del SCHEDULERS[n_sched:]
    emit("service_breaker_hang", **hang, trapped_warnings=len(expected),
         phase_s=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# phase 13: the operator and the sidecar's client half
# ---------------------------------------------------------------------------

#: phase 13's sizes: (a) the slice's batch through the operator over gRPC;
#: (b) the README's simulation (``demo --pods 500``); (c) the reference
#: bench's ``measure_delta_serving`` defaults
OPERATOR = {"wire": (40, 2500), "max_ticks": 8, "demo_pods": 500,
            "demo_timeout_s": 420.0, "delta_pods": 20_000,
            "delta_churn": 8, "delta_steps": 40, "delta_trace_sample": 16,
            "rpc_timeout_s": 900.0}
_DEMO_LINE = re.compile(
    r"-> (\d+) nodes, \$([0-9.]+)/hr, pending=(\d+)"
    r"(?:, saved \$(-?[0-9.]+)/hr)?")


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def http_get(url: str):
    """(status, content type, body) of one GET; an HTTP error status is
    returned, not raised."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return (resp.status, resp.headers.get("Content-Type", ""),
                    resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type", ""), ""


def node_multiset(nodes) -> dict:
    out: dict = {}
    for n in nodes:
        key = f"{n.instance_type}|{n.zone}|{n.capacity_type}"
        out[key] = out.get(key, 0) + 1
    return out


def obs_endpoints(base: str, want_hier: bool) -> dict:
    """GET the sidecar's /metrics, /statusz, /tracez and /sloz: each must
    answer 200 with Prometheus text or JSON that shows the solves."""
    out = {}
    code, ctype, text = http_get(f"{base}/metrics")
    check(code == 200 and ctype.startswith("text/plain")
          and "karpenter_admission_admitted_total" in text,
          f"/metrics answered {code} {ctype}")
    if want_hier:
        check('karpenter_solver_hier_solves_total{path="hierarchical"} 1'
              in text, "/metrics does not show the hierarchical solve")
    out["metrics"] = dict(status=code, bytes=len(text))
    for path in ("statusz", "tracez", "sloz"):
        code, ctype, body = http_get(f"{base}/{path}")
        check(code == 200 and ctype == "application/json",
              f"/{path} answered {code} {ctype}")
        out[path] = dict(status=code, bytes=len(body))
        doc = json.loads(body)
        if path == "statusz":
            admitted = doc["admission"]["admitted"]
            check(admitted.get("critical", 0) >= 1,
                  f"/statusz shows no critical solve: {admitted}")
            out[path]["admitted"] = admitted
            out[path]["replica_id"] = doc["replica_id"]
        elif path == "tracez":
            check(doc["count"] >= 1 and doc["spans"],
                  "/tracez shows no trace of the solves")
            out[path]["traces"] = doc["count"]
            out[path]["span_names"] = sorted(doc["spans"])
        else:
            check("classes" in doc and "occupancy" in doc,
                  f"/sloz keys {sorted(doc)}")
            out[path]["device_busy_share"] = \
                doc["occupancy"]["device_busy_share"]
    return out


def operator_wire_100k(full, st, limit, slice_res):
    """(a): the slice's 100,000 pods under the slice's limit through the
    port's ``Operator`` whose ``RemoteScheduler`` dials a
    ``SolverService`` over ``BatchScheduler(backend="tpu")`` on the card,
    on a unix socket; the sidecar's obs server on a loopback port and the
    operator's ``/fleetz`` merging it.  Returns (launches, the fields)."""
    import tempfile

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.cloud.fake import FakeCloudProvider
    from karpenter_tpu_torch.metrics import (
        HIER_SOLVES,
        REMOTE_DEGRADED,
        REMOTE_FALLBACK_SOLVES,
        Registry,
    )
    from karpenter_tpu_torch.obs import FlightRecorder, Tracer
    from karpenter_tpu_torch.obs import export as obs_export
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.service.server import SolverService, make_server
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.utils.clock import FakeClock

    nd, per = OPERATOR["wire"]
    pods = deployments(nd, per)
    reg_s = Registry()
    tracer = Tracer(registry=reg_s, flight=FlightRecorder(
        registry=reg_s, slow_trace_s=SERVICE["wire_trace_budget_s"]))
    sched = BatchScheduler(backend="tpu", registry=reg_s, tracer=tracer)
    service = SolverService(sched, registry=reg_s)
    address = f"unix:{tempfile.mkdtemp(prefix='kt-op-')}/solver.sock"
    server, _ = make_server(service, host=address)
    obs_server, obs_port = obs_export.serve(
        reg_s, service.tracer.flight, port=0, host="127.0.0.1",
        extra=service.statusz_extra, sloz=service.sloz,
        tunez=service.tunez)
    base = f"http://127.0.0.1:{obs_port}"
    clock = FakeClock()
    reg_o = Registry()
    op = Operator(FakeCloudProvider(full, clock=clock), clock=clock,
                  registry=reg_o, scheduler_backend="tpu",
                  solver_address=address, metrics_port=free_port())
    # the facade's 60 s RPC deadline is the reference's default; this one
    # request runs 30-42 s on the card (PERF.md), so give it the phase's
    # budget rather than let a slow host turn it into a local fallback
    op.scheduler.client.timeout = OPERATOR["rpc_timeout_s"]
    rpcs: list = []
    solve_raw = op.scheduler.client.solve_raw

    def counted(request, timeout=None):
        t0 = time.perf_counter()
        resp = solve_raw(request, timeout=timeout)
        rpcs.append(dict(pods=len(request.pods),
                         request_bytes=request.ByteSize(),
                         rpc_wall_ms=(time.perf_counter() - t0) * 1000.0,
                         solve_ms=resp.solve_ms,
                         replica_id=resp.replica_id))
        return resp

    op.scheduler.client.solve_raw = counted
    ticks: list = []
    try:
        op.state.apply_provisioner(provisioner(limit))
        t0 = time.perf_counter()
        for p in pods:
            op.state.add_pod(p)
        add_ms = (time.perf_counter() - t0) * 1000.0
        hier0 = reg_s.counter(HIER_SOLVES).get({"path": "hierarchical"})
        names_from()
        kernels.reset_counts()
        for _ in range(OPERATOR["max_ticks"]):
            t0 = time.perf_counter()
            op.tick()
            ticks.append((time.perf_counter() - t0) * 1000.0)
            clock.advance(1.5)
            if rpcs and not op.state.pending_pods():
                break
        launches = {k.name: k.launches for k in kernels.ALL}
        stats = dict(sched.hier_stats)
        endpoints = obs_endpoints(base, want_hier=True)
        op_port = op.start_http()
        os.environ["KT_OBS_PEERS"] = base
        try:
            code, _ctype, body = http_get(
                f"http://127.0.0.1:{op_port}/fleetz")
        finally:
            os.environ.pop("KT_OBS_PEERS", None)
        check(code == 200, f"the operator's /fleetz answered {code}")
        fleet = json.loads(body)
        sidecar_id = endpoints["statusz"]["replica_id"]
        check(fleet["partial"] is False and sidecar_id in fleet["replicas"],
              f"/fleetz did not merge the sidecar: partial="
              f"{fleet.get('partial')}, replicas={sorted(fleet['replicas'])}")
        nodes = [ns.node for ns in op.state.nodes.values()]
        pending = len(op.state.pending_pods())
        bound = len(op.state.bindings)
        fallback = reg_o.counter(REMOTE_FALLBACK_SOLVES).get()
        degraded = reg_o.gauge(REMOTE_DEGRADED).get()
        hier = reg_s.counter(HIER_SOLVES).get({"path": "hierarchical"}) \
            - hier0
    finally:
        op.shutdown()
        obs_server.shutdown()
        server.stop(0)
        service.close()
        sched.stop_warms()
    cost = sum(n.price for n in nodes)
    shipped = cpu_bought(st, nodes)
    same_nodes = node_multiset(nodes) == node_multiset(slice_res.nodes)
    check(hier == 1, f"{hier} hierarchical solves on the sidecar, not 1")
    check(launches["price_step_score"] >= 1
          and launches["price_step_score"] == stats["price_iters"],
          "price_step_score launches != price iterations through the "
          "operator")
    check(launches["packed_score"] == 0,
          "the operator's solve launched the price-row entry")
    # node prices cross the wire as float32: the sum agrees to 1e-6
    check(same_nodes and abs(cost - slice_res.new_node_cost)
          <= 1e-6 * slice_res.new_node_cost,
          f"the operator's nodes differ from the slice's ({len(nodes)} "
          f"at {cost} against {len(slice_res.nodes)} at "
          f"{slice_res.new_node_cost})")
    check(pending == 0 and bound == len(pods),
          f"{pending} pods pending, {bound} bound of {len(pods)}")
    check(shipped <= limit * (1.0 + 1e-6),
          f"shipped cpu {shipped} exceeds the limit {limit}")
    check(fallback == 0 and degraded == 0,
          f"remote fallback solves {fallback}, degraded {degraded}")
    return launches, dict(
        pods=len(pods), add_pods_ms=add_ms, ticks=len(ticks),
        tick_wall_ms=ticks, rpcs=len(rpcs), rpc=rpcs,
        sidecar_solve_ms=[r["solve_ms"] for r in rpcs],
        hier_total_ms=stats["total_ms"], price_iters=stats["price_iters"],
        launches=launches, nodes=len(nodes), cost=cost,
        node_multiset_equal_slice=same_nodes, pods_bound=bound,
        pods_pending=pending, shipped_cpu=shipped, cpu_limit=limit,
        remote_fallback_solves=fallback, remote_degraded=degraded,
        obs=endpoints, fleetz_replicas=sorted(fleet["replicas"]),
        fleetz_partial=fleet["partial"],
        fleetz_unreachable=len(fleet["unreachable"]))


def _cli(*args) -> list:
    return [sys.executable, "-m", "karpenter_tpu_torch.cli", *args]


def demo_lines(stdout: str) -> dict:
    """The demo's scale-up and scale-down lines, parsed."""
    found = [m for m in (_DEMO_LINE.search(ln) for ln in
                         stdout.splitlines()) if m]
    check(len(found) >= 2, f"demo printed {len(found)} result lines")
    up, down = found[0], found[1]
    return dict(
        up_line=up.group(0), down_line=down.group(0),
        up_nodes=int(up.group(1)), up_cost=float(up.group(2)),
        up_pending=int(up.group(3)), down_nodes=int(down.group(1)),
        down_cost=float(down.group(2)), down_pending=int(down.group(3)),
        saved=float(down.group(4)))


def start_demo_sidecar() -> dict:
    """(b)'s ``cli serve`` on the card as a subprocess, started before (a)
    so that its start-up overlaps (a)'s run; it serves nothing until (b)."""
    port, obs_port = free_port(), free_port()
    env = {k: v for k, v in os.environ.items() if k != "KT_OBS_PEERS"}
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        _cli("serve", "--backend", "tpu", "--port", str(port),
             "--obs-port", str(obs_port)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    return dict(proc=proc, port=port, obs_port=obs_port, env=env,
                t_start=t_start)


def operator_demo_cli(started: dict) -> dict:
    """(b): the sidecar of :func:`start_demo_sidecar`, ``cli demo
    --solver-address`` against it with no card visible, and the same demo
    in-process on the card in a fresh process (the two demos run side by
    side).  The scale-up lines must agree.  ``sidecar_wait_s`` is what
    (b) still waited for the sidecar's first Health answer."""
    from karpenter_tpu_torch.service.client import SolverClient

    sidecar, port, obs_port, env = (started["proc"], started["port"],
                                    started["obs_port"], started["env"])
    pods = str(OPERATOR["demo_pods"])
    procs = [sidecar]
    try:
        t_wait = time.perf_counter()
        deadline = started["t_start"] + 180.0
        while True:
            client = SolverClient(f"127.0.0.1:{port}", timeout=2.0)
            try:
                ok = client.health().ok
            except Exception:  # noqa: BLE001  (not listening yet)
                ok = False
            finally:
                client.close()
            if ok:
                break
            check(sidecar.poll() is None and time.perf_counter() < deadline,
                  "the sidecar never answered Health")
            time.sleep(0.5)
        sidecar_wait_s = time.perf_counter() - t_wait
        t0 = time.perf_counter()
        remote = subprocess.Popen(
            _cli("demo", "--pods", pods, "--backend", "tpu",
                 "--solver-address", f"127.0.0.1:{port}", "--tracez"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**env, "CUDA_VISIBLE_DEVICES": ""})
        local = subprocess.Popen(
            _cli("demo", "--pods", pods, "--backend", "tpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        procs += [remote, local]
        r_out, r_err = remote.communicate(timeout=OPERATOR["demo_timeout_s"])
        remote_s = time.perf_counter() - t0
        l_out, l_err = local.communicate(timeout=OPERATOR["demo_timeout_s"])
        local_s = time.perf_counter() - t0
        endpoints = obs_endpoints(f"http://127.0.0.1:{obs_port}",
                                  want_hier=False)
        sidecar.send_signal(signal.SIGTERM)
        s_out, s_err = sidecar.communicate(timeout=120)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(remote.returncode == 0, f"the remote demo exited "
          f"{remote.returncode}: {r_err[-2000:]}")
    check(local.returncode == 0, f"the in-process demo exited "
          f"{local.returncode}: {l_err[-2000:]}")
    check(sidecar.returncode == 0 and "solver sidecar stopped" in s_out
          and "draining" in s_out,
          f"the sidecar did not drain and stop on SIGTERM "
          f"(rc {sidecar.returncode}): {s_out[-1000:]} {s_err[-1000:]}")
    rl, ll = demo_lines(r_out), demo_lines(l_out)
    check(rl["up_line"] == ll["up_line"],
          f"scale-up differs: remote {rl['up_line']!r}, in-process "
          f"{ll['up_line']!r}")
    for name, lines in (("remote", rl), ("in-process", ll)):
        check(lines["up_pending"] == 0 and lines["down_pending"] == 0,
              f"the {name} demo left pods pending")
        check(lines["saved"] > 0, f"the {name} demo saved nothing")
    statusz = json.loads(r_out.split("== /statusz ==", 1)[1])
    # every local-fallback serve of RemoteScheduler logs a warning naming
    # the fallback, and a degraded facade sets remote_degraded
    fell_back = [ln for ln in r_err.splitlines()
                 if "fallback" in ln or "unreachable" in ln]
    check(not fell_back and statusz["fallbacks"]["remote_degraded"] is False,
          f"the remote demo fell back: {fell_back[:3]}")
    check(endpoints["statusz"]["admitted"].get("critical", 0) >= 1,
          "the sidecar served no critical solve")
    return dict(
        pods=OPERATOR["demo_pods"], sidecar_wait_s=sidecar_wait_s,
        remote_wall_s=remote_s, in_process_wall_s=local_s,
        remote=rl, in_process=ll,
        scale_down_equal=rl["down_line"] == ll["down_line"],
        remote_fallback_warnings=len(fell_back),
        remote_statusz_degraded=statusz["fallbacks"]["remote_degraded"],
        sidecar_admitted=endpoints["statusz"]["admitted"],
        sidecar_exit=sidecar.returncode,
        sidecar_drained="draining" in s_out)


def operator_delta_wire() -> dict:
    """(c): the reference bench's ``measure_delta_serving`` through the
    port: a ``DeltaSession`` against ``SolverService`` over
    ``BatchScheduler(backend="tpu")`` on the card, on a unix socket,
    server traces 1-in-16, client tracing off."""
    import random
    import tempfile

    import bench_torch as bt
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics import DELTA_RPC, Registry
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.obs.trace import Tracer
    from karpenter_tpu_torch.service.client import (
        DeltaSession,
        RemoteScheduler,
    )
    from karpenter_tpu_torch.service.server import SolverService, make_server
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    catalog = generate_catalog(full=False)
    provs = [provisioner()]
    reg = Registry()
    sched = BatchScheduler(backend="tpu", registry=reg)
    tracer = Tracer(registry=reg, sample_every=OPERATOR["delta_trace_sample"],
                    flight=getattr(sched.tracer, "flight", None))
    service = SolverService(sched, registry=reg, tracer=tracer)
    sock = f"unix:{tempfile.mkdtemp(prefix='kt-delta-')}/solver.sock"
    server, _ = make_server(service, host=sock)
    churn, steps = OPERATOR["delta_churn"], OPERATOR["delta_steps"]
    try:
        pods = bt._warmstart_pods(OPERATOR["delta_pods"], "dw")
        os.environ["KT_TRACE"] = "0"
        try:
            sess = DeltaSession(sock, timeout=600.0)
        finally:
            os.environ.pop("KT_TRACE", None)
        names_from()
        kernels.reset_counts()
        t0 = time.perf_counter()
        cur = sess.solve(pods, provs, catalog)
        establish_ms = (time.perf_counter() - t0) * 1000.0
        rng = random.Random(11)
        live = [p.name for p in pods]
        times = []
        for k in range(steps):
            rm = rng.sample(live, churn)
            gone = set(rm)
            live = [n for n in live if n not in gone]
            add = bt._warmstart_pods(churn, f"dwc{k}")
            t0 = time.perf_counter()
            cur = sess.solve_delta(added=add, removed=rm)
            times.append((time.perf_counter() - t0) * 1000.0)
            live += [p.name for p in add]
        launches = {k.name: k.launches for k in kernels.ALL}
        steady = sorted(times[1:])  # step 0 builds the chain metadata
        pipe = list(service._pipelines.values())[0]
        entry = pipe._delta_tab.get(sess.session_id)

        def node_map(nodes):
            return {n.name: sorted(p.name for p in n.pods) for n in nodes}

        parity = (entry is not None
                  and entry.prev.assignments == cur.assignments
                  and entry.prev.infeasible == cur.infeasible
                  and node_map(entry.prev.nodes) == node_map(cur.nodes))
        rpc = reg.counter(DELTA_RPC)
        outcomes = {dict(k)["outcome"]: v for k, v in rpc.values.items()}
        unexplained = (rpc.get({"outcome": "fallback_full"})
                       + rpc.get({"outcome": "session_unknown"}))
        remote = RemoteScheduler(sock, timeout=600.0)
        t0 = time.perf_counter()
        full = remote.solve([sess._pods[n] for n in live], provs, catalog)
        fullsolve_ms = (time.perf_counter() - t0) * 1000.0
        remote.close()
        cost_ratio = (cur.new_node_cost / full.new_node_cost
                      if full.new_node_cost else 1.0)
        resends = sess.full_resends
        sess.close()
    finally:
        server.stop(0)
        service.close()
        sched.stop_warms()
    check(parity, "the client's merged view differs from the server's "
          "chain state")
    check(cost_ratio <= 1.02, f"chain cost ratio {cost_ratio} > 1.02")
    check(unexplained == 0 and resends == 1,
          f"{unexplained} full-solve fallbacks or session losses, "
          f"{resends} full resends")
    check(launches["packed_score"] == 0
          and launches["price_step_score"] == 0,
          "a hand-written kernel launched on the delta chain")
    return dict(
        pods=OPERATOR["delta_pods"], churn=churn, steps=steps,
        trace_sample=OPERATOR["delta_trace_sample"],
        establish_ms=establish_ms, step_ms=times,
        p50_ms=steady[len(steady) // 2],
        p99_ms=steady[int(0.99 * (len(steady) - 1))],
        p50_gate_ms=3.0, fullsolve_rpc_ms=fullsolve_ms,
        chain_cost=cur.new_node_cost, fresh_cost=full.new_node_cost,
        cost_ratio=cost_ratio, parity=parity, rpc_outcomes=outcomes,
        unexplained_fallbacks=unexplained, full_resends=resends,
        launches=launches)


def phase_operator(st, limit, slice_res):
    """Phase 13: (a) the 100k batch through the operator over gRPC, (b)
    the deployed two-process topology through the CLI (its sidecar started
    before (a)), (c) the wire delta chain.  Returns (a)'s kernel
    launches."""
    from karpenter_tpu_torch.models.catalog import generate_catalog

    t_phase = time.perf_counter()
    PHASE[0] = "operator"
    full = generate_catalog(full=True)
    sidecar = start_demo_sidecar()
    try:
        launches, wire = operator_wire_100k(full, st, limit, slice_res)
    except BaseException:
        sidecar["proc"].kill()
        sidecar["proc"].communicate()
        raise
    emit("operator_wire_100k", **wire)
    emit("operator_demo_cli", **operator_demo_cli(sidecar))
    emit("operator_delta_wire", **operator_delta_wire(),
         phase_s=time.perf_counter() - t_phase)
    guard_clean("operator")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the device mesh and multi-process execution
# ---------------------------------------------------------------------------


#: phase 14's sizes: (b)'s serving requests and sweep candidates, (c)'s
#: ranks and megabatch slots
MESH = {"virtual": 8, "serving": 8, "sweep": 16, "ranks": 2,
        "rank_devices": 4, "slots": 8}
#: 14(c)'s ``MHOST`` verdict (the dryrun's ``summary``), which 16(c)'s
#: ``measure_multihost_fence`` reads instead of running the ranks again
MHOST: dict = {}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def node_types(res) -> list:
    return sorted((n.instance_type, n.zone, n.capacity_type) for n in res.nodes)


def mesh_hier_100k(limit, slice_stats, slice_res, slice_wall_ms):
    """(a): a world-size-1 ``torch.distributed`` job on nccl, ``make_mesh()``
    over the card, and the reference's limited solve through
    ``BatchScheduler(backend="auto", mesh=mesh)`` from the reference's
    name counter: hierarchical routing, every block wave a sharded megabatch,
    one ``price_step_scores`` launch per price iteration, the reference's
    plan."""
    import torch
    import torch.distributed as dist

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics import (
        HIER_SOLVES,
        MEGABATCH_FLUSH,
        Registry,
    )
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.parallel.distributed import initialize
    from karpenter_tpu_torch.parallel.mesh import make_mesh, mesh_signature
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    backend = initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda:0")
    try:
        check(backend == "nccl", f"the world-size-1 job runs on {backend}")
        mesh = make_mesh()
        check(mesh.shape == {"pods": 1, "types": 1},
              f"make_mesh() over one card gave {mesh.shape}")
        catalog = generate_catalog(full=True)
        pods = deployments(*LATER_HIER)
        sched = BatchScheduler(backend="auto", mesh=mesh,
                               registry=Registry())
        sharded = []
        real = TpuSolver._enqueue_sharded

        def spy(self, padded, *a, **kw):
            sharded.append(len(padded))
            return real(self, padded, *a, **kw)

        TpuSolver._enqueue_sharded = spy
        try:
            names_from(slice_stats["names_at"])
            kernels.reset_counts()
            res, wall_ms = _synced_ms(lambda: sched.solve(
                pods, [provisioner(limit)], catalog))
            launches = {k.name: k.launches for k in kernels.ALL}
        finally:
            TpuSolver._enqueue_sharded = real
        stats = dict(sched.hier_stats)
        st, _ = sched._tensorize(pods, [provisioner(limit)], catalog, (),
                                 None)
        shipped = cpu_bought(st, res.nodes)
        check(sched.registry.counter(HIER_SOLVES).get(
            {"path": "hierarchical"}) == 1,
              "the meshed solve did not route hierarchically")
        check(len(sharded) == stats["dispatches"] and sharded,
              f"{len(sharded)} sharded dispatches for "
              f"{stats['dispatches']} block waves")
        check(sched.registry.counter(MEGABATCH_FLUSH).get(
            {"reason": "mesh_serial"}) == 0, "a meshed flush went serial")
        check(launches["price_step_score"] == stats["price_iters"] >= 1,
              f"price_step_score launched {launches['price_step_score']} "
              f"times for {stats['price_iters']} price iterations")
        check(launches["packed_score"] == 0,
              "the meshed path launched the price-row entry")
        check(plan(res) == plan(slice_res),
              "the meshed plan differs from the reference's")
        check(shipped <= limit * (1.0 + 1e-6) and not res.infeasible,
              "the meshed solve broke the limit or left pods out")
        return launches, dict(
            backend=backend, mesh=mesh.shape,
            signature=[list(x) for x in mesh_signature(mesh)],
            wall_ms=wall_ms, reference_wall_ms=slice_wall_ms,
            blocks=stats["blocks"], waves=stats["waves"],
            dispatches=stats["dispatches"], padded_slots=sharded,
            price_iters=stats["price_iters"], wave_ms=stats["wave_ms"],
            repair_ms=stats["repair_ms"], nodes=len(res.nodes),
            cost=res.new_node_cost, infeasible=len(res.infeasible),
            cpu_shipped=shipped, cpu_limit=limit, launches=launches,
            plan_equal_slice=True,
            peak_mem_gib=torch.cuda.max_memory_allocated() / GIB)
    finally:
        dist.destroy_process_group()


def mesh_virtual_8():
    """(b): eight virtual shards on the card (shape (4, 2)) against the
    unmeshed path on ``cuda``: the sharded single solve of the 64-pod and
    the 10,000-pod scenarios, 8 serving requests in one sharded flush, the
    16-candidate sweep."""
    import bench_torch as bt
    from karpenter_tpu_torch.metrics import (
        MEGABATCH_FLUSH,
        MEGABATCH_SLOTS,
        Registry,
    )
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.parallel.mesh import make_mesh
    from karpenter_tpu_torch.solver import consolidation as cons
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.solver.tpu import TpuSolver, solve_dims
    from scripts.dryrun_multihost_torch import bench_scenario, scenario

    n = MESH["virtual"]
    mesh = make_mesh(devices=["cuda:0"] * n)
    check(mesh.shape == {"pods": 4, "types": 2},
          f"{n} virtual shards gave {mesh.shape}")
    out = dict(mesh=mesh.shape)
    solver = TpuSolver()

    def solo_vs_mesh(st, **kw):
        names_from()
        solo, solo_ms = _synced_ms(lambda: solver.solve(st, **kw).result)
        names_from()
        meshed, mesh_ms = _synced_ms(
            lambda: solver.solve(st, mesh=mesh, **kw).result)
        check(node_types(meshed) == node_types(solo)
              and abs(meshed.new_node_cost - solo.new_node_cost) < 1e-4
              and meshed.infeasible == solo.infeasible == {},
              "a sharded single solve differs from the unmeshed one")
        return dict(nodes=len(meshed.nodes), cost=meshed.new_node_cost,
                    solo_ms=solo_ms, mesh_ms=mesh_ms)

    out["toy_64"] = solo_vs_mesh(scenario())
    stb = bench_scenario()
    dims = solve_dims(stb, NE=0, node_budget=2048, a=4, b=2)
    check(dims["NR"] >= 2048 and dims["C"] >= 512,
          f"the bench scenario's padded dims shrank: {dims}")
    out["bench_10k"] = dict(
        solo_vs_mesh(stb, max_nodes=2048, track_assignments=False),
        G=dims["G"], C=dims["C"], NR=dims["NR"])

    # 8 serving requests in one sharded flush
    small = generate_catalog(full=False)
    provs = [provisioner()]
    clients = [bt._serving_pods(c) for c in range(MESH["serving"])]
    solo_sched = BatchScheduler(backend="auto")
    solos = []
    for pods in clients:
        names_from()
        solos.append(solo_sched.solve(pods, provs, small, relax=False))
    reg = Registry()
    sched = BatchScheduler(backend="auto", mesh=mesh, registry=reg)
    blocks = []
    real = sched._tpu._enqueue_entries

    def spy(entries, *a, **kw):
        blocks.append(len(entries))
        return real(entries, *a, **kw)

    sched._tpu._enqueue_entries = spy
    results, flush_ms = flush(sched, clients, provs, small)
    sched._tpu._enqueue_entries = real
    blocks = blocks[:1]  # the flush's dispatch, before any later wave
    h = reg.histogram(MEGABATCH_SLOTS)
    equal = [plan(r) == plan(s) for r, s in zip(results, solos)]
    check(all(equal), f"{equal.count(False)} sharded-flush plans differ "
          "from their solo plans")
    check(sum(h.totals.values()) == 1
          and sum(h.sums.values()) == len(clients),
          "the serving requests did not ride one flush")
    check(blocks == [len(clients)],
          f"the flush was not one block on the card: {blocks}")
    check(reg.counter(MEGABATCH_FLUSH).get({"reason": "mesh_serial"}) == 0,
          "the meshed flush went serial")
    out["serving_flush"] = dict(requests=len(clients), blocks=blocks,
                                flush_ms=flush_ms, plans_equal=sum(equal))

    # the 16-candidate sweep of phase 8 on the meshed scheduler
    cluster = bt._sweep_cluster()
    cands = [[i] for i in range(MESH["sweep"])]

    def sweep(on):
        return _synced_ms(lambda: cons.sweep_what_ifs(
            on, cluster, cands, provisioners=provs, instance_types=small,
            max_new=1))

    plain, plain_ms = sweep(BatchScheduler(backend="tpu"))
    meshed, meshed_ms = sweep(BatchScheduler(backend="tpu", mesh=mesh))
    check(meshed.path == "batched" and meshed.dispatches == 1,
          f"the meshed sweep was not one batched dispatch "
          f"({meshed.path}, {meshed.dispatches})")
    check([_decision(r) for r in meshed.results]
          == [_decision(r) for r in plain.results],
          "the meshed sweep's decisions differ from the unmeshed sweep's")
    out["sweep"] = dict(candidates=len(cands), path=meshed.path,
                        dispatches=meshed.dispatches, mesh_ms=meshed_ms,
                        plain_ms=plain_ms)
    return out


def mesh_two_processes():
    """(c): two ranks on the card over gloo, four mesh entries each (the
    bench's ``measure_multihost_fence`` layout; ``launch_workers`` running
    ``scripts/dryrun_multihost_torch.py``): each asserts the host-major
    layout on the real ranks, serves one 8-slot megabatch SPMD (owned
    range = ``slot_hosts``, half the fence bytes, foreign slots typed with
    their owner, owned plans equal to serial solves), and rank 0 forwards
    one foreign slot to its owner's ``SolverService`` over gRPC
    (``KT_MULTIHOST_PEERS``).  The launcher's verdict is kept in
    :data:`MHOST` for 16(c)."""
    from scripts.dryrun_multihost_torch import run, summary

    t0 = time.perf_counter()
    recs = run(MESH["ranks"], MESH["rank_devices"], device="cuda:0",
               timeout=400)
    wall_s = time.perf_counter() - t0
    MHOST.update(summary(recs, MESH["ranks"], MESH["rank_devices"]))
    check(all(r["ok"] and r["backend"] == "gloo" for r in recs),
          "a rank failed or did not run on gloo")
    check(all(r["read"] * MESH["ranks"] == r["total"] for r in recs),
          "a rank did not read exactly its share of the fence bytes")
    check(all(r["slots"] == MESH["slots"] for r in recs),
          "the megabatch was not padded to its 8 slots")
    fwd = [r["forward"] for r in recs if r["forward"]["forwarded"]]
    check(len(fwd) == 1, "no foreign slot was forwarded")
    check(MHOST["parity"], "a rank's megabatch slot diverged from its "
          "serial solve")
    return dict(ranks=recs, forwarded=fwd[0], summary=dict(MHOST),
                wall_s=wall_s)


def phase_mesh(limit, slice_stats, slice_res, slice_wall_ms):
    """Phase 14: (a) the meshed reference solve, (b) virtual shards on one
    card, (c) two processes on the card.  Returns (a)'s kernel launches."""
    t_phase = time.perf_counter()
    PHASE[0] = "mesh"
    with hier_at(LATER_HIER[0] * LATER_HIER[1]):
        launches, real = mesh_hier_100k(limit, slice_stats, slice_res,
                                        slice_wall_ms)
    emit("mesh_hier_100k", **real)
    emit("mesh_virtual_8", **mesh_virtual_8())
    emit("mesh_two_processes", **mesh_two_processes(),
         phase_s=time.perf_counter() - t_phase)
    guard_clean("mesh")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the analysis package (ktlint, the model checker, the lock
# sanitizer, trace conformance)
# ---------------------------------------------------------------------------

#: phase 15's sizes: (a)/(b) the CLI over the checkout; (c) 12(a)'s
#: closed-loop set-up at 8 and 32 clients, then the reference's batch over
#: gRPC beside 8 clients; (d) 13(c)'s wire chain plus a session closed
#: and re-established; (c)'s windows 2 s (4 s, cut when phase 17 came in)
ANALYSIS = {"concurrency": (8, 32), "seconds": 2.0, "wire_clients": 8,
            "second_pods": 2000, "second_steps": 4, "cli_timeout_s": 600.0}


def analysis_cli(*args):
    """``python -m karpenter_tpu_torch.analysis *args`` as a subprocess
    from the checkout, with no summary cache: (exit code, stdout, wall
    ms)."""
    env = {k: v for k, v in os.environ.items() if k != "KT_SANITIZE"}
    env["KT_LINT_CACHE"] = "0"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.analysis", *args],
        cwd=Path(__file__).resolve().parent, env=env, capture_output=True,
        text=True, timeout=ANALYSIS["cli_timeout_s"])
    wall_ms = (time.perf_counter() - t0) * 1000.0
    check(proc.returncode in (0, 1) and proc.stdout.strip(),
          f"analysis {args} exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    return proc.returncode, proc.stdout, wall_ms


def analysis_lint() -> dict:
    """(a): the analyzer over the port and its lock order, the two runs
    at once."""
    with ThreadPoolExecutor(2) as pool:
        lint = pool.submit(analysis_cli, "--format", "json")
        lock_order = pool.submit(analysis_cli, "--lock-order", "--format",
                                 "json")
        (rc, out, wall_ms), (rc2, out2, order_ms) = (lint.result(),
                                                     lock_order.result())
    doc = json.loads(out)
    check(rc == 0 and doc["findings"] == [],
          f"ktlint over the port: rc {rc}, {len(doc['findings'])} findings "
          f"{doc['findings'][:3]}")
    order = json.loads(out2)
    check(rc2 == 0 and order["order"], "--lock-order failed")
    by_rule: dict = {}
    for f in doc["suppressed"]:
        by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
    return dict(files=doc["files"], findings=len(doc["findings"]),
                suppressed=len(doc["suppressed"]),
                suppressed_by_rule=by_rule, lint_wall_ms=wall_ms,
                lock_order=order["order"], lock_edges=len(order["edges"]),
                lock_order_wall_ms=order_ms)


def analysis_model() -> dict:
    """(b): the three protocol models, explored exhaustively."""
    rc, out, wall_ms = analysis_cli("--model", "--format", "json")
    doc = json.loads(out)
    check(rc == 0 and doc["ok"], f"--model: rc {rc}, {doc}")
    models = {m["model"]: dict(ok=m["ok"], states=m["states"],
                               transitions=m["transitions"],
                               exhaustive=m["exhaustive"],
                               ms=m["elapsed_ms"])
              for m in doc["models"]}
    check(len(models) == 3 and all(m["ok"] and m["exhaustive"]
                                   for m in models.values()),
          f"a protocol model failed: {models}")
    return dict(models=models, wall_ms=wall_ms)


def analysis_sanitized(full, limit, slice_stats, slice_res):
    """(c): ``sanitize.install()``, then 12(a)'s closed-loop set-up at 8
    and 32 clients (an 8-slot ``SolvePipeline`` over ``backend="tpu"``)
    and the reference's limited batch as one ``Solve`` RPC through
    ``make_server`` (over ``backend="auto"``, admission on) while 8
    clients keep sending to it; every ``SanitizerError`` constructed is
    counted.  Returns (the reference RPC's kernel launches, the phase's
    fields)."""
    import tempfile
    import threading

    import grpc

    import bench_torch as bt
    from karpenter_tpu_torch import kernels, metrics
    from karpenter_tpu_torch.analysis import sanitize
    from karpenter_tpu_torch.metrics import FLIGHT_DUMPS, HIER_SOLVES, Registry
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.obs import FlightRecorder, Tracer
    from karpenter_tpu_torch.service import codec
    from karpenter_tpu_torch.service import solver_pb2 as pb
    from karpenter_tpu_torch.service.server import (
        SERVICE as RPC_SERVICE,
        SolvePipeline,
        SolverService,
        make_server,
    )
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    raised: list = []
    base_error = sanitize.SanitizerError

    class CountedSanitizerError(base_error):
        def __init__(self, *args):
            raised.append(str(args[0]) if args else "")
            super().__init__(*args)

    sanitize.SanitizerError = CountedSanitizerError
    sanitize.install()
    small = generate_catalog(full=False)
    provs = [provisioner()]
    clients = [bt._serving_pods(c) for c in range(SERVICE["clients"])]
    reg = Registry()
    tracer = Tracer(registry=reg, flight=FlightRecorder(
        registry=reg, slow_trace_s=SERVICE["wire_trace_budget_s"]))
    server = service = None
    try:
        sched = BatchScheduler(backend="tpu", registry=reg, tracer=tracer)
        check(type(sched._tpu._lock).__name__ == "_OrderedLock",
              "the sanitizer did not proxy the solver's lock")
        st, _ = sched._tensorize_cache.tensorize(clients[0], provs, small)
        rung, rungs = 2, [None]
        while rung <= SERVICE["max_slots"]:
            rungs.append(rung)
            rung *= 2
        t0 = time.perf_counter()
        for s in rungs:
            sched._tpu.warm_async(st, on_done=sched._warm_done, slots=s)
        while not sched._tpu.warm_idle():
            time.sleep(0.05)
        warm_s = time.perf_counter() - t0
        solo = SOLO_PLANS or [plan(sched.solve(p, provs, small, relax=False))
                              for p in clients]

        def kwargs_of(ci):
            return dict(pods=clients[ci], provisioners=provs,
                        instance_types=small)

        loops = {}
        for c in ANALYSIS["concurrency"]:
            pipe = SolvePipeline(sched, registry=reg,
                                 max_slots=SERVICE["max_slots"],
                                 admission=False)
            try:
                names_from(100_000)
                counts, last, lat, _s, wall = bt.closed_loop(
                    pipe, kwargs_of, c, ANALYSIS["seconds"])
            finally:
                pipe.stop()
            equal = [plan(r) == solo[ci] for ci, r in enumerate(last)
                     if r is not None]
            check(all(equal) and len(equal) == c,
                  f"a sanitized tenant at concurrency {c} planned "
                  "differently from its solo solve")
            loops[f"c{c}"] = dict(
                solves=sum(counts), solves_per_s=sum(counts) / wall,
                p50_ms=percentile(lat, 0.5) * 1e3,
                p99_ms=percentile(lat, 0.99) * 1e3,
                plans_equal_solo=sum(equal))

        # the reference's batch over the wire beside 8 closed-loop clients,
        # through the service's own pipeline (admission on) over an
        # ``auto`` scheduler, as phase 4 solved it (its guard threads run
        # every device call)
        wire_sched = BatchScheduler(backend="auto", registry=reg,
                                    tracer=tracer)
        service = SolverService(wire_sched, registry=reg, tracer=tracer,
                                max_slots=SERVICE["max_slots"])
        address = f"unix:{tempfile.mkdtemp(prefix='kt-san-')}/solver.sock"
        server, _port = make_server(service, host=address)
        limits = [("grpc.max_receive_message_length", 256 * 1024 * 1024),
                  ("grpc.max_send_message_length", 256 * 1024 * 1024)]
        n_wire = ANALYSIS["wire_clients"]
        wire_reqs = [codec.encode_request(clients[ci], provs, small)
                     for ci in range(n_wire)]
        stop = threading.Event()
        served = [0] * n_wire
        last_wire: list = [None] * n_wire
        errors: list = []

        def wire_client(ci):
            channel = grpc.insecure_channel(address, options=limits)
            try:
                call = channel.unary_unary(
                    f"/{RPC_SERVICE}/Solve",
                    request_serializer=pb.SolveRequest.SerializeToString,
                    response_deserializer=pb.SolveResponse.FromString)
                while not stop.is_set():
                    resp = call(wire_reqs[ci], timeout=900.0)
                    last_wire[ci] = codec.decode_response(resp)
                    served[ci] += 1
            except Exception as err:  # reported after the join
                errors.append(repr(err))
            finally:
                channel.close()

        threads = [threading.Thread(target=wire_client, args=(ci,))
                   for ci in range(n_wire)]
        for t in threads:
            t.start()
        channel = grpc.insecure_channel(address, options=limits)
        try:
            solve = channel.unary_unary(
                f"/{RPC_SERVICE}/Solve",
                request_serializer=pb.SolveRequest.SerializeToString,
                response_deserializer=pb.SolveResponse.FromString)
            req = codec.encode_request(deployments(*LATER_HIER),
                                       [provisioner(limit)], full)
            while min(served) == 0 and not errors:
                time.sleep(0.05)  # every client is sending
            hier0 = reg.counter(HIER_SOLVES).get({"path": "hierarchical"})
            names_from(slice_stats["names_at"])
            kernels.reset_counts()
            t0 = time.perf_counter()
            resp = solve(req, timeout=OPERATOR["rpc_timeout_s"])
            rpc_ms = (time.perf_counter() - t0) * 1000.0
            launches = {k.name: k.launches for k in kernels.ALL}
            during = list(served)
        finally:
            channel.close()
            stop.set()
            for t in threads:
                t.join()
        res = codec.decode_response(resp)
        edges = sorted(sanitize.observed_lock_edges())
        stats = dict(wire_sched.hier_stats)
    finally:
        if server is not None:
            server.stop(0)
        if service is not None:
            service.close()
        sanitize.uninstall()
        sanitize.SanitizerError = base_error
    regs = {id(r): r for r in (reg, metrics.registry)}
    dumps = sum(r.counter(FLIGHT_DUMPS).get({"reason": "sanitizer_error"})
                for r in regs.values())
    check(not errors, f"a wire client failed: {errors[:3]}")
    check(not raised, f"{len(raised)} SanitizerError: {raised[:3]}")
    check(dumps == 0, f"{dumps} sanitizer_error flight dumps")
    order = {n: i for i, n in enumerate(sanitize.LOCK_ORDER)}
    inverted = [(a, b) for a, b in edges if a in order and b in order
                and a != b and order[a] > order[b]]
    check(not inverted, f"observed lock edges invert LOCK_ORDER: "
          f"{inverted}")
    check(reg.counter(HIER_SOLVES).get({"path": "hierarchical"})
          == hier0 + 1, "the sanitized reference RPC did not route "
          "hierarchically")
    check(launches["price_step_score"] == stats["price_iters"] >= 1,
          f"price_step_score launched {launches['price_step_score']} "
          f"times for {stats['price_iters']} price iterations")
    check(launches["packed_score"] == 0,
          "the sanitized path launched the price-row entry")
    equal = plan(res) == plan(slice_res)
    tie = placements_tie(res, slice_res)
    check(equal or tie, "the sanitized plan differs from the reference's")
    wire_equal = [plan(r) == solo[ci] for ci, r in enumerate(last_wire)
                  if r is not None]
    check(len(wire_equal) == n_wire and all(wire_equal),
          "a wire client's plan beside the reference RPC differs from its solo "
          "plan")
    return launches, dict(
        lock_order_entries=len(sanitize.LOCK_ORDER), warm_s=warm_s,
        **loops, wire_clients=n_wire, wire_served_during=during,
        wire_served=served, wire_plans_equal_solo=sum(wire_equal),
        rpc_wall_ms=rpc_ms, solve_ms=resp.solve_ms,
        price_iters=stats["price_iters"], launches=launches,
        nodes=len(res.nodes), cost=res.new_node_cost,
        infeasible=len(res.infeasible), plan_equal_slice=equal,
        placements_tie_slice=tie, sanitizer_errors=len(raised),
        sanitizer_dumps=dumps, observed_lock_edges=[list(e) for e in edges],
        host_routed=host_routed(reg))


def reestablished_session() -> dict:
    """(d)'s second session: a chain on ``backend="tpu"`` closed, then
    re-established under the same session id and driven again."""
    import tempfile

    import bench_torch as bt
    from karpenter_tpu_torch.metrics import DELTA_RPC, Registry
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.service.client import DeltaSession
    from karpenter_tpu_torch.service.server import SolverService, make_server
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    catalog = generate_catalog(full=False)
    provs = [provisioner()]
    reg = Registry()
    service = SolverService(BatchScheduler(backend="tpu", registry=reg),
                            registry=reg)
    sock = f"unix:{tempfile.mkdtemp(prefix='kt-again-')}/solver.sock"
    server, _ = make_server(service, host=sock)
    out = []
    try:
        for rnd in range(2):
            sess = DeltaSession(sock, session_id="reestablished",
                                timeout=600.0)
            pods = bt._warmstart_pods(ANALYSIS["second_pods"], f"re{rnd}")
            sess.solve(pods, provs, catalog)
            live = [p.name for p in pods]
            for k in range(ANALYSIS["second_steps"]):
                rm, live = live[:8], live[8:]
                add = bt._warmstart_pods(8, f"re{rnd}c{k}")
                sess.solve_delta(added=add, removed=rm)
                live += [p.name for p in add]
            out.append(dict(epoch=sess.epoch,
                            full_resends=sess.full_resends))
            sess.close()
        rpc = {dict(k)["outcome"]: v
               for k, v in reg.counter(DELTA_RPC).values.items()}
    finally:
        server.stop(0)
        service.close()
    check(all(r["full_resends"] == 1 for r in out),
          f"the re-established session resent more than once: {out}")
    return dict(rounds=out, rpc_outcomes=rpc)


def analysis_conformance() -> dict:
    """(d): 13(c)'s wire delta chain and a re-established session under
    the port's transition tap, checked against the model-checked
    automaton."""
    from karpenter_tpu_torch.analysis import conformance
    from karpenter_tpu_torch.obs import protocol

    t0 = time.perf_counter()
    with protocol.recording() as rec:
        chain = operator_delta_wire()
        again = reestablished_session()
    events = rec.events_by_session()
    report = conformance.check_events(events)
    check(report.ok, report.format())
    check(len(events) == 2, f"{len(events)} sessions recorded, not 2")
    counts: dict = {}
    for seq in events.values():
        for name, _attrs in seq:
            counts[name] = counts.get(name, 0) + 1
    return dict(sessions=report.sessions, events=report.events,
                violations=len(report.violations), event_counts=counts,
                chain_steps=chain["steps"], chain_p50_ms=chain["p50_ms"],
                chain_p99_ms=chain["p99_ms"],
                chain_cost_ratio=chain["cost_ratio"],
                chain_launches=chain["launches"],
                reestablished=again, wall_s=time.perf_counter() - t0)


def phase_analysis(full, limit, slice_stats, slice_res):
    """Phase 15: (a) ktlint and the lock order, (b) the protocol models,
    (c) the sanitized serving stack with the reference RPC, (d) trace
    conformance of the wire delta chain.  Returns (c)'s kernel
    launches."""
    t_phase = time.perf_counter()
    PHASE[0] = "analysis"
    # (a) and (b) run on the host only: their three CLI runs at once
    with ThreadPoolExecutor(2) as pool:
        lint, model = pool.submit(analysis_lint), pool.submit(analysis_model)
        emit("analysis_lint", **lint.result())
        emit("analysis_model", **model.result())
    # the 8 clients' requests wait behind the reference RPC in the admission
    # queue, so the brownout ladder may step (a logged warning) and
    # recover; any other trapped warning fails the run
    n_faults = len(FAULTS.records)
    with hier_at(LATER_HIER[0] * LATER_HIER[1]):
        launches, sanitized = analysis_sanitized(full, limit, slice_stats,
                                                 slice_res)
    trapped = FAULTS.records[n_faults:]
    check(all(r.startswith("karpenter_tpu_torch.admission.brownout: "
                           "brownout ") for r in trapped),
          f"unexpected warnings: {trapped}")
    del FAULTS.records[n_faults:]
    emit("analysis_sanitized", **sanitized, brownout_transitions=trapped)
    emit("analysis_conformance", **analysis_conformance(),
         phase_s=time.perf_counter() - t_phase)
    guard_clean("analysis")
    return launches


#: phase 16's configs through ``karpenter-tpu-torch bench`` and the
#: subprocess's time limit
BENCH = {"configs": "2,6", "timeout_s": 600}


def bench_cli() -> dict:
    """16(a): ``karpenter-tpu-torch bench`` as a subprocess on the card.
    Every line must parse, carry no ``error`` and name the card; config 2
    must seat every pod."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        _cli("bench", "--configs", BENCH["configs"]),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(Path(__file__).resolve().parent))
    try:
        out, err = proc.communicate(timeout=BENCH["timeout_s"])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0,
          f"cli bench exited {proc.returncode}: {err[-2000:]}")
    lines = {}
    for ln in out.strip().splitlines():
        try:
            rec = json.loads(ln)
        except ValueError:
            raise SmokeFailure(f"cli bench printed an unparsable line: "
                               f"{ln[:300]}") from None
        check("error" not in rec, f"cli bench config line failed: {rec}")
        check(bool(rec.get("gpu")), f"cli bench line without gpu: {rec}")
        check(rec.get("device") == "cuda", f"cli bench off the card: {rec}")
        lines[rec["config"]] = rec
    want = [int(c) for c in BENCH["configs"].split(",")]
    check(sorted(lines) == want, f"cli bench printed configs {sorted(lines)}")
    check(lines[2]["infeasible"] == 0,
          f"config 2 left {lines[2]['infeasible']} pod(s) infeasible")
    return dict(configs=lines, wall_s=time.perf_counter() - t0)


#: 16(c): the bench's probes whose paths no earlier phase drives, run in
#: process at the bench's sizes, but for ``measure_tuning``'s pairs and
#: requests per capture (the bench runs 2 pairs of 96; cut to 1 pair when
#: phase 17 came in, a pair taking 20–38 s, then to 48 requests)
BENCH_PROBES = ("measure_warm_coldstart", "measure_multihost_fence",
                "measure_replay_fidelity", "measure_tuning")
TUNING = {"pairs": 1, "n": 48}


def bench_probes() -> dict:
    """16(c): the :data:`BENCH_PROBES` of ``bench_torch`` on the card, at
    the bench's sizes.  ``measure_multihost_fence`` reads 14(c)'s rank run
    (:data:`MHOST`, the bench's layout) and drives only its lone-request
    A/B.  Kernel counts are zeroed just before and read just after, the
    children's (each warm cold start process, each rank, each A/B run)
    added from the counts they print; no hand-written kernel is on these
    paths.  The budget flags ``check_budgets`` raises on the fragments
    are returned, not failed on; a probe that raises fails the phase."""
    import bench_torch
    from karpenter_tpu_torch import kernels

    check(bool(MHOST), "14(c) left no MHOST verdict")
    rec, walls, children = {}, {}, {}
    kwargs = {"measure_warm_coldstart": dict(launches=children),
              "measure_multihost_fence": dict(
                  n_processes=MESH["ranks"],
                  local_devices=MESH["rank_devices"], summary=MHOST,
                  launches=children),
              "measure_tuning": dict(TUNING)}
    kernels.reset_counts()
    for name in BENCH_PROBES:
        t0 = time.perf_counter()
        rec.update(getattr(bench_torch, name)(**kwargs.get(name, {})))
        walls[name] = time.perf_counter() - t0
    launches = kernels.counts()
    check(set(children) == set(launches),
          f"the children counted {sorted(children)}, not every kernel")
    check(rec["cold_first_solve_warm_served_cold"] is False,
          "the warmed first serving solve was served cold")
    check(rec["multihost_parity"] is True,
          "a rank's megabatch slot diverged from its serial solve")
    check(rec["replay_errors"] == 0 and rec["replay_class_mix_match"] is True,
          f"replay: {rec['replay_errors']} errors, class mix "
          f"{rec['replay_class_mix_match']}")
    check(rec["tuning_replay_errors"] == 0,
          f"{rec['tuning_replay_errors']} replayed requests errored in the "
          "tuning runs")
    check(not any(price_loop(launches).values())
          and not any(price_loop(children).values()),
          f"a price-loop kernel launched on a bench probe's path: "
          f"{launches} in process, {children} in the children")
    return dict(rec, probe_s=walls, launches=launches,
                child_launches=children,
                budget_flags=bench_torch.check_budgets(rec).get(
                    "budget_flags", []))


def phase_bench():
    """Phase 16: (a) ``cli bench --configs 2,6`` in a subprocess, (b) the
    headline's tensorize tiers and ``bench_torch.measure_hierarchical`` in
    process, kernel counts zeroed just before (b) and read just after,
    (c) :func:`bench_probes`.  Returns (b)'s kernel launches."""
    import bench_torch
    from karpenter_tpu_torch import kernels

    t_phase = time.perf_counter()
    PHASE[0] = "bench"
    cli = bench_cli()
    emit("bench_cli", **cli)
    pods, provs, catalog = bench_torch.build_scenario()
    _st, tensorize = bench_torch.measure_tensorize(
        pods, provs, catalog, bench_torch.build_scenario()[0])
    check(tensorize["tensorize_parity"],
          "cached tensorize diverged from the from-scratch build")
    kernels.reset_counts()
    t0 = time.perf_counter()
    hier = bench_torch.measure_hierarchical(None)
    launches = {k.name: k.launches for k in kernels.ALL}
    hier_s = time.perf_counter() - t0
    check("hier_error" not in hier, f"hierarchical bench: {hier}")
    check(hier["hier_pallas_parity"],
          "the packed-score kernel diverged from its plain version")
    check(hier["hier_disjoint_parity"],
          "the block-disjoint hierarchical plan diverged from the flat one")
    rec = {**tensorize, **hier,
           "cost_ratio_vs_ffd": cli["configs"][2]["cost_ratio_vs_ffd"]}
    emit("bench_hierarchical", **tensorize, **hier, launches=launches,
         hier_s=hier_s,
         budget_flags=bench_torch.check_budgets(rec).get("budget_flags", []),
         phase_s=time.perf_counter() - t_phase)
    t0 = time.perf_counter()
    emit("bench_probes", **bench_probes(), wall_s=time.perf_counter() - t0,
         phase_s=time.perf_counter() - t_phase)
    guard_clean("bench")
    return launches


# ---------------------------------------------------------------------------
# phase 17: resilience — chaos, restart and fleet failover on the card
# ---------------------------------------------------------------------------


#: phase 17's sizes: (a) the chaos run at 12 of ``run_chaos``'s 60 steps
#: and its 1,500 pods (cut to 30, then to 20 to keep the script inside its
#: time, and to 12 when phase 18 came in: every fault of the schedule
#: still falls inside them); (b) the restart at 500 pods over
#: ``run_restart``'s 4 clients (its 4,000 cut to 1,000, and to 500 when
#: phase 18 came in: the bench runs them); (c) ``run_fleet``'s defaults (3
#: replicas, 6 clients of 200 pods)
RESILIENCE = {"chaos_steps": 12, "chaos_pods": 1500, "restart_pods": 500}


def _threads(fn):
    """``fn()``'s result with the process's thread count at its start and
    end (teardown must stop what the driver started).  A stopped gRPC
    server's pool threads exit once the server is collected, so where
    threads are left after 0.5 s the end count is read after a collection
    and up to 2 s more for them to exit."""
    import gc
    import threading

    start = threading.active_count()
    t0 = time.perf_counter()
    try:
        out = fn()
    except AssertionError as e:  # a driver's invariant broke
        raise SmokeFailure(f"{PHASE[0]}: {e}") from None
    wall_s = time.perf_counter() - t0

    def settle(seconds):
        deadline = time.perf_counter() + seconds
        while (threading.active_count() > start
               and time.perf_counter() < deadline):
            time.sleep(0.05)

    settle(0.5)
    if threading.active_count() > start:
        gc.collect()
        settle(2.0)
    return dict(out, threads_start=start,
                threads_end=threading.active_count(), wall_s=wall_s)


def resilience_chaos() -> dict:
    """17(a): ``run_chaos`` on the card (``backend="tpu"``) at a cut depth:
    the composed 8-kind schedule against the fault-free mirror, the four
    invariants asserted inside the driver at every step."""
    from scripts import chaos_drive_torch as chaos

    board = _threads(lambda: chaos.run_chaos(
        steps=RESILIENCE["chaos_steps"], pods_n=RESILIENCE["chaos_pods"],
        verbose=False))
    typed = sum(board["typed_errors"].values())
    check(board["device"].startswith("cuda"), f"chaos ran on {board}")
    check(board["faults_injected"] >= 6
          and len(board["injected_by_rule"]) >= 6,
          f"the schedule did not fire: {board['injected_by_rule']}")
    check(board["parity_checked_steps"] >= board["steps"] - typed,
          f"{board['parity_checked_steps']} parity-checked steps of "
          f"{board['steps']} with {typed} typed errors")
    return board


def resilience_restart() -> dict:
    """17(b): ``run_restart(snapshot=True)``: the sidecar subprocess on the
    card SIGTERM'd mid-chain and relaunched on the card; every session
    restored warm.  Both sidecars report their kernel launches at
    shutdown."""
    from scripts import chaos_drive_torch as chaos

    board = _threads(lambda: chaos.run_restart(
        pods_n=RESILIENCE["restart_pods"], snapshot=True, verbose=False))
    check(board["extra_resends"] == 0,
          f"{board['extra_resends']} re-establishes after the restart")
    check(board["device"].startswith("cuda"), f"restart ran on {board}")
    return board


def resilience_fleet() -> dict:
    """17(c): ``run_fleet(mode="kill")``: three replicas and the mirror on
    the card, one replica hard-killed, its sessions steal-adopted warm.
    The clients whose home died log the endpoint dead (one warning each),
    which is expected here."""
    from scripts import chaos_drive_torch as chaos

    n_faults = len(FAULTS.records)
    board = _threads(lambda: chaos.run_fleet(mode="kill", verbose=False))
    trapped = FAULTS.records[n_faults:]
    victim_sock = board["victim"].replace("replica-", "/r") + ".sock"
    check(all(r.startswith("karpenter_tpu_torch.service.client: fleet "
                           "endpoint ") and r.endswith(f"{victim_sock} "
                                                       "-> dead")
              for r in trapped), f"unexpected warnings: {trapped}")
    del FAULTS.records[n_faults:]
    stolen = board["adoptions"].get("stolen", 0)
    check(board["victim_sessions"] >= 1, "the kill orphaned no session")
    check(board["extra_resends"] == 0,
          f"{board['extra_resends']} re-establishes after the kill")
    check(stolen >= board["victim_sessions"],
          f"{stolen} steals for {board['victim_sessions']} orphans")
    return dict(board, dead_endpoint_warnings=len(trapped))


def phase_resilience():
    """Phase 17: (a) the chaos run, (b) the kill-and-restart, (c) the
    fleet kill, all on the card.  Kernel counts are zeroed just before and
    read just after, the restart's two sidecars' added from the counts
    they print; no hand-written kernel is on these paths.  Returns the
    in-process and the sidecars' launches, summed."""
    from karpenter_tpu_torch import kernels

    t_phase = time.perf_counter()
    PHASE[0] = "resilience"
    kernels.reset_counts()
    emit("resilience_chaos", **resilience_chaos())
    restart = resilience_restart()
    emit("resilience_restart", **restart)
    emit("resilience_fleet", **resilience_fleet())
    launches = kernels.counts()
    children = {name: sum(c.get(name, 0) for c in restart["server_launches"])
                for name in launches}
    check(all(set(c) == set(launches) for c in restart["server_launches"]),
          f"a sidecar counted {restart['server_launches']}, not every "
          "kernel")
    check(not any(price_loop(launches).values())
          and not any(price_loop(children).values()),
          f"a price-loop kernel launched on a resilience path: "
          f"{launches} in process, {children} in the sidecars")
    emit("resilience", launches=launches, sidecar_launches=children,
         phase_s=time.perf_counter() - t_phase)
    guard_clean("resilience")
    return {name: launches[name] + children[name] for name in launches}


#: phase 18's depth: seeds per suite, (seeds, steps) of the delta and
#: wire chains, seeds of the relax / hierarchical / gang sweeps, steps of
#: the sanitized battle seed (the script's defaults are 40; 12 x 4;
#: 10 x 4; 25, 12, 20; the reference's battletest takes 120 steps)
FUZZ = {"suite_seeds": 6, "delta": (2, 4), "wire": (1, 4), "relax": 2,
        "hier": 2, "gang": 2, "battle_steps": 30}


def _problems(records, what: str) -> None:
    bad = {r["seed"]: r["problems"] for r in records if r.get("problems")}
    check(not bad, f"{what}: {bad}")


def fuzz_suites() -> dict:
    """18(a): each suite's seeds solved on the card and on the host from
    one counter state (existing nodes named from 0, solves from 1000):
    equal plans or ``placements_tie``, the validator, the floor and the
    per-seed ceiling against the port's oracle on the card's plans."""
    from scripts import fuzz_sweep_torch as fz

    out = {}
    for suite in ("plain", "existing", "kubelet"):
        run = {dev: fz.run_suite(suite, FUZZ["suite_seeds"], device=dev,
                                 reset_names=True, verbose=False)
               for dev in (None, "cpu")}
        cuda, cpu = run[None], run["cpu"]
        check(cuda["device"].startswith("cuda"), f"{suite} ran on "
              f"{cuda['device']}")
        _problems(cuda["records"], f"fuzz {suite} on the card")
        ties = 0
        for a, b in zip(cuda["records"], cpu["records"]):
            if a.get("skipped"):
                continue
            check(fz.same_plan(a["result"], b["result"]),
                  f"fuzz {suite} seed {a['seed']}: cuda and cpu plans "
                  "differ")
            ties += fz.plan(a["result"]) != fz.plan(b["result"])
            check(a["ratio"] is None or a["ratio"] <= a["ceiling"] + 1e-9,
                  f"fuzz {suite} seed {a['seed']}: per-pod ratio "
                  f"{a['ratio']} over {a['ceiling']}")
        out[suite] = dict(n=cuda["n"], mean=cuda["mean"],
                          worst=cuda["worst"],
                          seeds=fz.summary(cuda["records"]),
                          cuda_solve=fz.walls(cuda["records"]),
                          cpu_solve=fz.walls(cpu["records"]),
                          placements_ties=ties)
    return out


def fuzz_chains(runner, seeds: int, steps: int, what: str) -> dict:
    """18(b)/(c): chains drawn on the card, replayed on the host from the
    same inputs and counter states: the same mode (or epoch) and plan at
    every step, the same from-scratch re-solves."""
    from scripts import fuzz_sweep_torch as fz

    cuda = runner(seeds, steps, device=None, verbose=False)
    cpu = runner(seeds, steps, device="cpu", replay=cuda, verbose=False)
    _problems(cuda, f"{what} on the card")
    checked = 0
    for a, b in zip(cuda, cpu):
        check(fz.same_plan(a["base"]["result"], b["base"]["result"]),
              f"{what} seed {a['seed']}: base plans differ")
        for i, (x, y) in enumerate(zip(a["steps"], b["steps"])):
            check(x["mode"] == y["mode"]
                  and fz.same_plan(x["result"], y["result"])
                  and fz.same_plan(x["full"], y["full"]),
                  f"{what} seed {a['seed']} step {i}: cuda {x['mode']} "
                  f"${x['cost']} vs cpu {y['mode']} ${y['cost']}")
            checked += 1
    return dict(seeds=[r["seed"] for r in cuda], steps_checked=checked,
                modes=[r["modes"] for r in cuda],
                costs=[[s["cost"] for s in r["steps"]] for r in cuda],
                device=cuda[0]["device"])


def fuzz_battle() -> dict:
    """18(e): one battle seed on ``backend="tpu"`` on the card under the
    installed lock sanitizer, every ``SanitizerError`` constructed
    counted; the sanitizer uninstalled afterwards."""
    from karpenter_tpu_torch.analysis import sanitize
    from scripts import fuzz_sweep_torch as fz

    raised: list = []
    base_error = sanitize.SanitizerError

    class CountedSanitizerError(base_error):
        def __init__(self, *args):
            raised.append(str(args[0]) if args else "")
            super().__init__(*args)

    sanitize.SanitizerError = CountedSanitizerError
    sanitize.install()
    try:
        out = fz.run_battle(0, steps=FUZZ["battle_steps"], backend="tpu",
                            device=fz._device(None))
    finally:
        sanitize.uninstall()
        sanitize.SanitizerError = base_error
    check(out["device"].startswith("cuda"), f"battle ran on {out['device']}")
    check(not out["problems"], f"battle: {out['problems'][:5]}")
    check(out["reaped"], f"battle: {out['nodes_left']} nodes never reaped")
    check(not raised, f"{len(raised)} SanitizerError: {raised[:3]}")
    out.pop("snapshots")
    return dict(out, sanitizer_errors=len(raised))


def phase_fuzz():
    """Phase 18: ``scripts/fuzz_sweep_torch.py``'s runners on the card —
    (a) the suites, (b) delta chains, (c) a wire chain, (d) relax,
    hierarchical and gang seeds, (e) a sanitized battle seed.  Kernel
    counts zeroed just before and read just after; no fuzz scenario
    reaches the hierarchical threshold, so they read 0.  Returns them."""
    from karpenter_tpu_torch import kernels
    from scripts import fuzz_sweep_torch as fz

    t_phase = time.perf_counter()
    PHASE[0] = "fuzz"
    kernels.reset_counts()
    t0 = time.perf_counter()
    emit("fuzz_suites", **fuzz_suites(), wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    emit("fuzz_delta", **fuzz_chains(fz.run_delta_chains, *FUZZ["delta"],
                                     "delta"),
         wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    emit("fuzz_delta_wire", **fuzz_chains(fz.run_delta_wire_chains,
                                          *FUZZ["wire"], "delta-wire"),
         wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    sweeps = {}
    for mode, runner in (("relax", fz.run_relax_seeds),
                         ("hier", fz.run_hier_seeds),
                         ("gang", fz.run_gang_seeds)):
        t1 = time.perf_counter()
        recs = runner(FUZZ[mode], device=None, verbose=False)
        _problems(recs, f"{mode} on the card")
        check(all(r["device"].startswith("cuda") for r in recs
                  if not r.get("skipped")), f"{mode} ran off the card")
        sweeps[mode] = dict(fz.summary(recs), wall_s=time.perf_counter() - t1)
        if mode == "relax":
            sweeps[mode]["outcomes"] = [r.get("outcome", r.get("skipped"))
                                        for r in recs]
    emit("fuzz_sweeps", **sweeps, wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    emit("fuzz_battle", **fuzz_battle(), phase_wall_s=time.perf_counter() - t0)
    launches = kernels.counts()
    check(not any(price_loop(launches).values()),
          f"a price-loop kernel launched on a fuzz path: {launches}")
    emit("fuzz", launches=launches, phase_s=time.perf_counter() - t_phase)
    guard_clean("fuzz")
    return launches



#: phase 19's depth: the measured solve's repeats (the script's default
#: is 5; 2 until phase 19 ran over its 60 s), and the hierarchical stage
#: table on its host walls only (its profiled solve, whose profiler stop
#: and event walk took 23 s on a slow card machine, is the script's
#: ``--hier-solve`` run)
TOOLS = {"repeats": 1, "hier_solve": True, "hier_profiled": False}
#: the share of each profiled solve's wall the named stages must cover
STAGE_COVERAGE = 0.9


def _stage_summary(table: dict) -> dict:
    """A stage table's coverage and its rows, each with its wall (the
    unprofiled run's and the profiled one's), launches, kernel ms, busy
    share and longest idle stretch."""
    return {k: table[k] for k in (
        "wall_ms", "profiled_wall_ms", "covered", "profiled_covered",
        "launches", "device_ms", "device_busy", "attributed_by",
        "clock_check_ms", "stages") if k in table}


def tools_profile() -> dict:
    """19(a): ``scripts/profile_solve_torch.py`` on config 2 (50,000 pods)
    with :data:`TOOLS`' repeats, and the stage table of the hierarchical
    demo's contended batch: the solves on the card, config 2's profiled
    launches counted, the named stages covering :data:`STAGE_COVERAGE` of
    each wall, the hierarchical solve's price iterations each launching
    ``price_step_scores`` once."""
    from scripts import profile_solve_torch as ps

    sink: dict = {}
    doc = ps.measure_solve(None, repeats=TOOLS["repeats"], trace_dir=None,
                           hier_solve=TOOLS["hier_solve"], sink=sink,
                           hier_profiled=TOOLS["hier_profiled"])
    check(doc["device"].startswith("cuda"), f"profiled on {doc['device']}")
    check(doc["launches"] > 0, "the profiled config-2 solve launched no "
          "CUDA kernel")
    check(doc["infeasible"] == 0, f"config 2 left {doc['infeasible']} pods "
          "infeasible")
    tables = {"config2": doc["stages"]}
    if TOOLS["hier_solve"]:
        hs = doc["hier_solve"]
        tables["hier"] = hs
        stats, launches = sink["hier_stats"], sink["hier_launches"]
        check(stats.get("price_iters", 0) >= 1,
              f"the hierarchical solve ran no price iteration: {stats}")
        check(launches["price_step_score"] == stats["price_iters"]
              and launches["packed_score"] == 0,
              f"{launches} for {stats['price_iters']} price iterations")
    for name, table in tables.items():
        for key in ("covered", "profiled_covered"):
            if key not in table:
                continue
            check(table[key] >= STAGE_COVERAGE,
                  f"{name}: the named stages cover {table[key]} of the "
                  f"wall ({key}), under {STAGE_COVERAGE}")
    out = {k: doc[k] for k in (
        "device", "gpu", "pods", "backend", "tunnel_rtt_ms", "tensorize_ms",
        "tensorize_cold_ms", "tensorize_steady_ms", "tensorize_steady_tier",
        "tensorize_shape_hit_ms", "tensorize_shape_tier", "first_call_ms",
        "solve_ms", "launches", "copies", "device_ms", "device_busy",
        "top_kernels", "nodes", "infeasible")}
    out["stages"] = _stage_summary(doc["stages"])
    if TOOLS["hier_solve"]:
        out["hier_solve"] = dict(
            _stage_summary(hs), **{k: hs[k] for k in (
                "pods", "limit_cpu", "blocks", "waves", "price_iters",
                "repair_pods", "tail_repack_pods", "nodes", "infeasible",
                "kernel_launches")})
    return out


def tools_hier_demo() -> dict:
    """19(b): ``scripts/hier_demo_torch.py`` on the card: its lines, its
    contended solve's plan against the same batch solved with
    ``device="cpu"`` from the same node-name counter, one
    ``price_step_scores`` launch per price iteration; the 250 ms verdict
    of its 1M model printed as a flag."""
    from scripts import fuzz_sweep_torch as fz
    from scripts import hier_demo_torch as hd

    t0 = time.perf_counter()
    run = hd.run(device=None)
    card_s = time.perf_counter() - t0
    check(not run["aborted"], "the hierarchical demo fell back to flat")
    check(run["device"].startswith("cuda"), f"demo ran on {run['device']}")
    stats, launches = run["stats"], run["launches"]
    check(stats["price_iters"] >= 1, f"no price iteration: {stats}")
    check(launches["price_step_score"] == stats["price_iters"]
          and launches["packed_score"] == 0,
          f"{launches} for {stats['price_iters']} price iterations")
    t0 = time.perf_counter()
    cpu, cpu_stats = hd.contended("cpu", run["pods"], run["limit_cpu"],
                                  run["names_at"])
    cpu_s = time.perf_counter() - t0
    check(fz.same_plan(run["result"], cpu),
          f"the card's contended plan ({len(run['result'].nodes)} nodes, "
          f"${run['result'].new_node_cost}) differs from the host's "
          f"({len(cpu.nodes)} nodes, ${cpu.new_node_cost})")
    check(cpu_stats["price_iters"] == stats["price_iters"],
          f"{stats['price_iters']} price iterations on the card, "
          f"{cpu_stats['price_iters']} on the host")
    res = run["result"]
    model = run["model"]
    return dict(
        partition=run["partition"], limit_cpu=run["limit_cpu"],
        blocks=stats["blocks"], waves=stats["waves"],
        dispatches=stats["dispatches"], price_iters=stats["price_iters"],
        repair_pods=stats["repair_pods"],
        tail_repack_pods=stats["tail_repack_pods"],
        total_ms=stats["total_ms"], wave_ms=stats["wave_ms"],
        score_ms=stats["score_ms"], repair_ms=stats["repair_ms"],
        nodes=len(res.nodes), cost=res.new_node_cost,
        infeasible=len(res.infeasible), launches=launches,
        plan_equal=fz.plan(res) == fz.plan(cpu),
        placements_tie=fz.plan(res) != fz.plan(cpu),
        model=model, verdict=run["verdict"],
        flag=None if run["verdict"] == "PASS" else (
            f"modeled 1M wall {model['total_ms']} ms over "
            f"{hd.HIER_BUDGET_MS} ms"),
        card_s=card_s, cpu_replay_s=cpu_s)


def tools_slo_demo() -> dict:
    """19(c): ``scripts/slo_demo_torch.py`` on the card: best_effort sheds
    and burns, critical's availability does not breach; critical's
    latency verdict printed beside its p99 and the objective's target."""
    from scripts import slo_demo_torch as slo

    report, doc = slo.run(backend="tpu", device=None)
    classes, fast = doc["classes"], doc["config"]["fast_burn"]
    be, crit = classes["best_effort"], classes["critical"]
    verdicts = {cls: {obj: slo.objective_verdict(info[obj], fast)
                      for obj in ("availability", "latency")}
                for cls, info in classes.items()}
    check(be["availability"]["lifetime"]["bad"] > 0
          and be["verdict"] in ("warn", "breach"),
          f"best_effort did not shed and burn: {verdicts['best_effort']}, "
          f"bad {be['availability']['lifetime']['bad']}")
    check(verdicts["critical"]["availability"] != "breach",
          f"critical breached its availability: {verdicts['critical']}")
    check(report["outcomes"].get("error", 0) == 0,
          f"replay errors: {report['outcomes']}")
    return dict(outcomes=report["outcomes"],
                verdicts={c: i["verdict"] for c, i in classes.items()},
                objectives=verdicts,
                reference_rule_holds=slo.split_holds(doc),
                critical_p99_ms=slo.critical_p99_ms(report),
                critical_latency_bad=crit["latency"]["lifetime"]["bad"],
                critical_latency_total=crit["latency"]["lifetime"]["total"],
                latency_target_ms=doc["config"]["p99_ms"],
                occupancy=doc["occupancy"])


def tools_fleet_demo() -> dict:
    """19(d): ``scripts/fleet_trace_demo_torch.py`` on the card: one
    journey of at least 3 hops over at least 2 replicas, every later hop
    linked under the first.  The hard kill leaves each client whose home
    died one dead-endpoint warning, which is expected here."""
    from scripts import fleet_trace_demo_torch as fd

    n_faults = len(FAULTS.records)
    out = fd.run(backend="tpu", device=None, verbose=False)
    trapped = FAULTS.records[n_faults:]
    check(all(r.startswith("karpenter_tpu_torch.service.client: fleet "
                           "endpoint ") and r.endswith("-> dead")
              for r in trapped), f"unexpected warnings: {trapped}")
    del FAULTS.records[n_faults:]
    check(out["device"].startswith("cuda"), f"replicas on {out['device']}")
    check(out["ok"], f"the journey did not assemble: {out['journey']}")
    journey = out["journey"]
    return dict(ok=out["ok"], victim=out["victim"],
                served_after_kill=out["served_after_kill"],
                full_resends=out["full_resends"],
                n_hops=journey["n_hops"],
                replicas=sorted({h["replica"] for h in journey["hops"]}),
                parent_hops=[h["parent_hop"] for h in journey["hops"]],
                dead_endpoint_warnings=len(trapped))


def phase_tools():
    """Phase 19: the repo-level tools on the card — (a) the whole-solve
    profile, (b) the hierarchical demo, (c) the SLO demo, (d) the fleet
    tracing demo, each followed by a ``guard`` line.  Kernel counts are
    zeroed just before and read just after; the price loops of (a)'s
    hierarchical solves and (b)'s contended solve launch
    ``price_step_scores``.  Returns the counts."""
    from karpenter_tpu_torch import kernels

    t_phase = time.perf_counter()
    kernels.reset_counts()
    for name, fn in (("tools_profile", tools_profile),
                     ("tools_hier_demo", tools_hier_demo),
                     ("tools_slo_demo", tools_slo_demo),
                     ("tools_fleet_demo", tools_fleet_demo)):
        PHASE[0] = name
        t0 = time.perf_counter()
        emit(name, **fn(), wall_s=time.perf_counter() - t0)
        guard_clean(name)
    launches = kernels.counts()
    check(launches["packed_score"] == 0,
          f"packed_scan_scores launched on a tools path: {launches}")
    emit("tools", launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on "
              "the GPU and has nothing to do here", file=sys.stderr)
        return 2
    try:
        import karpenter_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: karpenter_tpu_torch is not importable; run "
              "from the repository root", file=sys.stderr)
        return 2
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.models.catalog import generate_catalog

    t_start = time.perf_counter()
    logging.getLogger("karpenter_tpu_torch").addHandler(FAULTS)
    install_guard_watch()

    def run(name, fn, *args):
        PHASE[0] = name
        out = fn(*args)
        guard_clean(name)
        return out

    try:
        smi = run("device", phase_device)
        run("build", phase_build)
        max_err = run("kernel", phase_kernel)
        st, stats, launches, limit, slice_res = run("slice", phase_slice,
                                                    40, 2500)
        timing = run("timing", phase_timing, st, stats)
        run("parity", phase_parity, 8, 250)
        ref_st, ref_stats, ref_limit, ref_res = run(
            "reference", phase_reference, *LATER_HIER)
        run("relax", phase_relax)
        run("consolidation", phase_consolidation)
        run("controllers", phase_controllers, ref_limit, ref_res,
            deployments(*LATER_HIER))
        flush_launches = run("serving", phase_serving, ref_limit, ref_res)
        gang_launches = phase_gangs()
        service_launches = phase_service(ref_limit, ref_res)
        operator_launches = phase_operator(st, limit, slice_res)
        mesh_launches = phase_mesh(ref_limit, ref_stats, ref_res,
                                   RECORD["reference"]["wall_ms"])
        analysis_launches = phase_analysis(generate_catalog(full=True),
                                           ref_limit, ref_stats, ref_res)
        bench_launches = phase_bench()
        resilience_launches = phase_resilience()
        fuzz_launches = phase_fuzz()
        tools_launches = phase_tools()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    score = "karpenter_tpu/solver/hierarchy.py:388"
    fills = "none (karpenter_tpu/ops/masks.py, fused by XLA)"
    table = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": kernel.repo_path,
        "replaces": replaces,
        "launches": (launches[name] + flush_launches[name]
                     + gang_launches[name] + service_launches[name]
                     + operator_launches[name] + mesh_launches[name]
                     + analysis_launches[name] + bench_launches[name]
                     + resilience_launches[name] + fuzz_launches[name]
                     + tools_launches[name]),
        "max_abs_err": max_err[name],
        "ms": timing[key]["kernel_ms"],
        "plain_ms": timing[key]["plain_ms"],
        "bound_ms": timing[key]["bound_ms"],
        "bound_by": timing[key]["bound_by"],
        "library_ms": timing[key]["library_ms"],
        "parity": "byte-equal",
    } for name, kernel, key, replaces in (
        ("packed_score", kernels.PACKED_SCORE, "packed", score),
        ("price_step_score", kernels.PRICE_STEP_SCORE, "step", score),
        ("skew_band_fill", kernels.SKEW_BAND_FILL, "skew_band_fill_1x3",
         fills),
        ("water_fill", kernels.WATER_FILL, "water_fill_1x3", fills))]}
    RECORD["kernels"] = table["kernels"]
    RECORD["wall_s"] = time.perf_counter() - t_start
    # what is left running when the script returns: non-daemon threads
    # hold the interpreter's exit until they end
    emit("exit", threads=sorted(f"{t.name}{'' if t.daemon else ' (non-daemon)'}"
                                for t in threading.enumerate()))
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    print(smi)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
