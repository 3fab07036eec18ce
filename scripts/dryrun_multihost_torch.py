#!/usr/bin/env python
"""Multi-process megabatch dryrun of the PyTorch port: per-host fences
proven on real ``torch.distributed`` ranks.

Launches N ranks on this machine through the port's ``launch_workers``,
each on ``--device`` (``cpu`` ranks over gloo, or ranks sharing one card,
also over gloo since NCCL refuses two ranks on one GPU).  Every rank runs
the port's ``worker_main`` (mesh layout on the real ranks, a sharded round
trip) with this script's work on top:

- **the sharded single solve**: every rank computes its feasibility
  blocks, gathers the rest and gets the whole plan; the ranks agree;
- **ownership**: each rank's owned slot range of one coalesced megabatch
  matches the host-major ownership map (``parallel/mesh.slot_hosts``);
- **addressable-only fences**: each rank reads back EXACTLY 1/N of the
  whole-batch bytes;
- **demux**: foreign slots resolve to ``SlotNotOwned`` naming the true
  owner; owned plans equal single-process serial solves (``parity``);
- **flush wall**: the steady sharded flush, median of 3 (``flush_ms``);
- **forwarding**: every rank serves a ``SolverService`` on a unix socket
  (``KT_MULTIHOST_PEERS``), rank 0 forwards one foreign slot through
  ``ResultForwarder`` and gets the plan its owner serves itself.

The scenarios are the reference driver's toy and bench-scale scenarios,
rebuilt from the port's models so that every rank builds identical
tensors.

    python scripts/dryrun_multihost_torch.py --device cpu
    python scripts/dryrun_multihost_torch.py --device cuda:0 --local-devices 1
    python scripts/dryrun_multihost_torch.py --lone-ab [--device cpu]

``--lone-ab`` is one process: a lone 1-request flush over 8 virtual
shards of the device, read back through the per-host fence
(``KT_MULTIHOST=1``) and through the whole-batch readback (``=0``) in
alternating pairs.

Machine-readable verdicts: one ``MHOSTW {...}`` JSON line per rank, one
``MHOST {...}`` summary from the launcher (``slots``, ``fence_frac``,
``flush_ms``, ``parity``, the ranks' kernel ``launches``), one
``LONE_AB {"on_ms", "off_ms", "ratio"}`` and one ``LAUNCHES {...}`` (its
kernel launches) from ``--lone-ab``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: request slots of the worker's megabatch (the reference dryrun's 8)
MEGABATCH_SLOTS = 8


# ---------------------------------------------------------------------------
# deterministic scenarios
# ---------------------------------------------------------------------------


def scenario_parts(n_pods: int = 64, tenant: str = ""):
    """(pods, provisioners, catalog) of the toy scenario: web pods with a
    zone spread, memory-heavy and cpu-heavy pods, two provisioners (one
    spot-only), the small catalog.  ``tenant`` varies pod names and request
    values while keeping the group structure, so every tenant lands in the
    same megabatch bucket."""
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.instancetype import GIB
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodSpec,
        TopologySpreadConstraint,
    )

    catalog = generate_catalog(full=False)
    pre = f"{tenant}-" if tenant else ""
    shift = sum(ord(c) for c in tenant) % 4
    sel = LabelSelector.of({"app": f"{pre}web"})
    pods = []
    for i in range(n_pods):
        if i % 3 == 0:
            pods.append(PodSpec(
                name=f"{pre}web-{i}", labels={"app": f"{pre}web"},
                requests={"cpu": 1.0 + 0.25 * shift, "memory": 2 * GIB},
                topology_spread=[TopologySpreadConstraint(
                    1, L.ZONE, "DoNotSchedule", sel)],
                owner_key=f"{pre}web"))
        elif i % 3 == 1:
            pods.append(PodSpec(
                name=f"{pre}mem-{i}",
                requests={"cpu": 0.5, "memory": (8 - shift) * GIB},
                owner_key=f"{pre}mem"))
        else:
            pods.append(PodSpec(
                name=f"{pre}cpu-{i}", requests={"cpu": 2.0 + 0.5 * shift},
                owner_key=f"{pre}cpu"))
    return pods, _provisioners(), catalog


def _provisioners():
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.models.requirements import IN, Requirement

    return [
        Provisioner(name="default", weight=5).with_defaults(),
        Provisioner(
            name="spot", weight=10,
            requirements=[Requirement(L.CAPACITY_TYPE, IN,
                                      [L.CAPACITY_TYPE_SPOT])],
        ).with_defaults(),
    ]


def scenario(n_pods: int = 64):
    from karpenter_tpu_torch.models.tensorize import tensorize

    pods, provs, catalog = scenario_parts(n_pods)
    return tensorize(pods, provs, catalog)


def bench_scenario(n_pods: int = 10_000):
    """Bench-scale tensors: the full catalog under two provisioners (the C
    axis pads past the 512 rung), 20 deployments, every other one
    zone-spread; with ``max_nodes=2048`` the NR axis sits on the 2048
    rung."""
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.instancetype import GIB
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodSpec,
        TopologySpreadConstraint,
    )
    from karpenter_tpu_torch.models.tensorize import tensorize

    catalog = generate_catalog(full=True)
    pods = []
    for d in range(20):
        sel = LabelSelector.of({"app": f"d{d}"})
        spread = ([TopologySpreadConstraint(1, L.ZONE, "DoNotSchedule", sel)]
                  if d % 2 == 0 else [])
        for i in range(n_pods // 20):
            pods.append(PodSpec(
                name=f"d{d}-{i}", labels={"app": f"d{d}"},
                requests={"cpu": 0.25 * (1 + d % 8),
                          "memory": (0.5 + d % 6) * GIB},
                topology_spread=list(spread), owner_key=f"d{d}"))
    return tensorize(pods, _provisioners(), catalog)


def plan_of(res) -> list:
    """Node-plan fingerprint, independent of the node-name counter."""
    return sorted(
        (n.instance_type, n.zone, n.capacity_type, round(n.price, 6),
         tuple(sorted(q.name for q in n.pods)))
        for n in res.nodes)


def names_from(start: int) -> None:
    """Restart the node-name counter: coalescing orders candidates by
    ``(size, name)``, so compared solves start from one counter state."""
    from karpenter_tpu_torch.solver import types

    with types._node_lock:
        types._node_next = start


# ---------------------------------------------------------------------------
# the worker's work
# ---------------------------------------------------------------------------


def _all_gather(obj) -> list:
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _sharded_solve(mesh, device) -> dict:
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    names_from(1000)
    res = TpuSolver(device=device).solve(scenario(), mesh=mesh).result
    assert res.nodes, "distributed sharded solve created no nodes"
    assert not res.infeasible, (
        f"distributed solve left {len(res.infeasible)} pods unplaced")
    plans = _all_gather(plan_of(res))
    assert all(p == plans[0] for p in plans), (
        "ranks disagree on the sharded solve's plan")
    return dict(nodes=len(res.nodes))


def _megabatch(mesh, device, n_slots: int) -> dict:
    """One coalesced ``n_slots`` megabatch served SPMD over the mesh, held
    to the per-host fence contract."""
    import torch.distributed as dist

    from karpenter_tpu_torch.models.tensorize import tensorize
    from karpenter_tpu_torch.parallel.forward import SlotNotOwned
    from karpenter_tpu_torch.parallel.mesh import local_slot_range, slot_hosts
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    rank, world = dist.get_rank(), dist.get_world_size()
    parts = [scenario_parts(48, tenant=f"mh{i}") for i in range(n_slots)]
    provs, catalog = parts[0][1], parts[0][2]
    sts = [tensorize(p, provs, catalog) for p, _pv, _c in parts]
    solver = TpuSolver(device=device)
    names_from(1000)
    handle = solver.solve_many_async([dict(st=st) for st in sts],
                                     min_slots=n_slots, mesh=mesh)
    outs = handle.results()
    owners = slot_hosts(mesh, handle.B_pad)
    lo, hi = local_slot_range(mesh, handle.B_pad)
    exp = [s for s, p in enumerate(owners) if p == rank]
    assert (lo, hi) == (exp[0], exp[-1] + 1), (
        f"owned range {(lo, hi)} != host-major ownership map {exp}")
    assert handle.owned_slots == (lo, hi)
    assert handle.fence_bytes_read * world == handle.fence_bytes_total, (
        f"per-host fence read {handle.fence_bytes_read} of "
        f"{handle.fence_bytes_total} bytes, not the 1/{world} share")
    n_foreign = 0
    for i, out in enumerate(outs):
        if lo <= i < hi:
            assert not isinstance(out, Exception), (i, out)
        else:
            assert isinstance(out, SlotNotOwned), (i, out)
            assert out.owner == owners[i], (i, out.owner, owners[i])
            n_foreign += 1
    diverged = []
    for i in range(lo, hi):
        names_from(1000 + 1000 * (i + 1))
        solo = solver.solve(sts[i]).result
        out = outs[i].result
        if (plan_of(out) != plan_of(solo)
                or set(out.assignments) != set(solo.assignments)
                or out.infeasible != solo.infeasible):
            diverged.append(i)
    parity = not diverged
    assert parity, (
        f"slots {diverged} diverged from the single-process serial solve")
    # the steady flush wall (median of 3): dispatch + per-host fence; every
    # rank runs the identical dispatch
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        solver.solve_many_async([dict(st=st) for st in sts],
                                min_slots=n_slots, mesh=mesh).results()
        walls.append((time.perf_counter() - t0) * 1000.0)
    return dict(owned=[lo, hi], slots=int(handle.B_pad), foreign=n_foreign,
                read=int(handle.fence_bytes_read),
                total=int(handle.fence_bytes_total),
                frac=handle.fence_bytes_read / max(1, handle.fence_bytes_total),
                parity=parity, flush_ms=sorted(walls)[1],
                owners=list(owners), parts=parts)


def _forward(device, mb: dict, coordinator: str) -> dict:
    """Every rank serves a ``SolverService`` on a unix socket (its endpoint
    listed, by rank, in ``KT_MULTIHOST_PEERS``); rank 0 forwards one slot
    another rank owns through ``ResultForwarder`` and holds the plan it
    gets back to the plan the owner serves itself."""
    import torch.distributed as dist

    from karpenter_tpu_torch.metrics import MULTIHOST_FORWARDS, Registry
    from karpenter_tpu_torch.parallel.forward import (
        ResultForwarder,
        SlotNotOwned,
    )
    from karpenter_tpu_torch.service.client import SolverClient
    from karpenter_tpu_torch.service.codec import (
        decode_response,
        encode_request,
    )
    from karpenter_tpu_torch.service.server import SolverService, make_server
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    rank, world = dist.get_rank(), dist.get_world_size()
    port = coordinator.rsplit(":", 1)[1]
    socks = [os.path.join(tempfile.gettempdir(), f"kt-mh-{port}-{r}.sock")
             for r in range(world)]
    os.environ["KT_MULTIHOST_PEERS"] = ",".join(f"unix:{p}" for p in socks)
    reg = Registry()
    service = SolverService(
        BatchScheduler(backend="tpu", device=device, registry=reg),
        registry=reg)
    server, _ = make_server(service, host=f"unix:{socks[rank]}")
    try:
        owners, parts = mb["owners"], mb["parts"]
        slot = next(i for i, p in enumerate(owners[:len(parts)]) if p != 0)
        owner = owners[slot]
        pods, provs, catalog = parts[slot]
        dist.barrier()  # every server is up
        own_plan = None
        if rank == owner:
            # the owner's plan: its own service answering the request
            names_from(50_000)
            client = SolverClient(f"unix:{socks[rank]}", timeout=600.0)
            try:
                own_plan = plan_of(decode_response(client.solve_raw(
                    encode_request(pods, provs, catalog))))
            finally:
                client.close()
        dist.barrier()
        got = None
        if rank == 0:
            fwd = ResultForwarder(registry=reg)
            assert fwd.enabled() and fwd.peers == [f"unix:{p}" for p in socks]
            names_from(50_000)
            try:
                got = plan_of(fwd.forward(
                    dict(pods=pods, provisioners=provs,
                         instance_types=catalog),
                    SlotNotOwned(slot, owner), priority="critical"))
            finally:
                fwd.close()
            assert reg.counter(MULTIHOST_FORWARDS).get(
                {"outcome": "forwarded"}) == 1
        dist.barrier()  # the owner keeps serving until the forward landed
        plans = _all_gather(own_plan)
        if rank == 0:
            assert got == plans[owner], (
                f"forwarded slot {slot} plan differs from its owner's")
        return dict(slot=slot, owner=owner, forwarded=rank == 0,
                    nodes=len(plans[owner]))
    finally:
        server.stop(grace=None)
        service.close()
        os.environ.pop("KT_MULTIHOST_PEERS", None)
        if os.path.exists(socks[rank]):
            os.unlink(socks[rank])


def work(mesh, device, args) -> dict:
    """The dryrun on top of ``worker_main``'s layout checks, with the
    rank's hand-written kernel launches over it (``launches``)."""
    from karpenter_tpu_torch import kernels

    kernels.reset_counts()
    rec = _sharded_solve(mesh, device)
    mb = _megabatch(mesh, device, MEGABATCH_SLOTS)
    fwd = (_forward(device, mb, args.coordinator)
           if args.num_processes > 1 else None)
    rec.update({k: v for k, v in mb.items() if k not in ("parts", "owners")})
    rec["forward"] = fwd
    rec["launches"] = kernels.counts()
    return rec


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def lone_ab(devices: int = 8, pairs: int = 5, device=None) -> dict:
    """One process, ``devices`` virtual shards of ``device`` (the card by
    default, raising without one): a lone 1-request meshed flush read back
    through the per-host fence (``KT_MULTIHOST=1``) against the
    whole-batch readback (``=0``), in pairs of alternating order; the
    medians and their ratio (the lone-request tax gate's input).  The
    kernel launches of the run are left in ``kernels``' counts."""
    from karpenter_tpu_torch.device import resolve_device
    from karpenter_tpu_torch.models.tensorize import tensorize
    from karpenter_tpu_torch.parallel.mesh import make_mesh
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    from karpenter_tpu_torch import kernels

    kernels.reset_counts()
    dev = resolve_device(device)
    mesh = make_mesh(devices=[dev] * devices)
    pods, provs, catalog = scenario_parts(48, tenant="mh0")
    st = tensorize(pods, provs, catalog)
    solver = TpuSolver(device=dev)
    solver.solve_many([dict(st=st)], mesh=mesh)  # first run of the shape
    prev = os.environ.get("KT_MULTIHOST")

    def flush(flag: str) -> float:
        os.environ["KT_MULTIHOST"] = flag
        t0 = time.perf_counter()
        solver.solve_many_async([dict(st=st)], mesh=mesh).results()
        return (time.perf_counter() - t0) * 1000.0

    try:
        flush("1"), flush("0")  # both readback paths once, off the record
        on, off = [], []
        for k in range(pairs):
            # alternating within-pair order: a monotone host drift biases
            # half the pairs each way
            if k % 2 == 0:
                on.append(flush("1"))
                off.append(flush("0"))
            else:
                off.append(flush("0"))
                on.append(flush("1"))
    finally:
        if prev is None:
            os.environ.pop("KT_MULTIHOST", None)
        else:
            os.environ["KT_MULTIHOST"] = prev
    on_ms = sorted(on)[len(on) // 2]
    off_ms = sorted(off)[len(off) // 2]
    return dict(on_ms=round(on_ms, 2), off_ms=round(off_ms, 2),
                ratio=round(on_ms / max(off_ms, 1e-9), 3))


def run(n_processes: int = 2, local_devices: int = 2, device=None,
        timeout: float = 600.0) -> list:
    """Launch the dryrun's ranks on ``device`` (the card by default,
    raising without one) and return their ``MHOSTW`` records; raises on
    any failure."""
    from karpenter_tpu_torch.device import resolve_device
    from karpenter_tpu_torch.parallel.distributed import launch_workers

    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           "--device", str(resolve_device(device))]
    outs = launch_workers(cmd, n_processes, local_devices, timeout=timeout)
    records = [json.loads(ln[len("MHOSTW "):]) for out in outs
               for ln in out.splitlines() if ln.startswith("MHOSTW ")]
    assert len(records) == n_processes, (
        f"{len(records)} worker verdicts for {n_processes} processes")
    return records


def summary(records: list, processes: int, local_devices: int) -> dict:
    """The launcher's ``MHOST`` verdict over the ranks' records: the
    worst fence fraction and flush wall, parity on every rank, the
    forwards, and the ranks' kernel launches summed."""
    launches: dict = {}
    for r in records:
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return dict(
        processes=processes, local_devices=local_devices,
        slots=records[0]["slots"],
        fence_frac=max(r["frac"] for r in records),
        flush_ms=max(r["flush_ms"] for r in records),
        parity=all(r["parity"] for r in records),
        forwarded=sum(1 for r in records
                      if r["forward"] and r["forward"]["forwarded"]),
        launches=launches)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--worker" in argv:
        from karpenter_tpu_torch.parallel.distributed import worker_main

        argv.remove("--worker")
        return worker_main(argv, work=work)
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="every rank's device (default: the card)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--lone-ab", action="store_true",
                    help="one process: the per-host fence against the "
                         "whole-batch readback on a lone meshed flush")
    ap.add_argument("--devices", type=int, default=8,
                    help="virtual shards of --device for --lone-ab")
    ap.add_argument("--pairs", type=int, default=5,
                    help="timed (on, off) pairs for --lone-ab")
    args = ap.parse_args(argv)
    if args.lone_ab:
        from karpenter_tpu_torch import kernels

        print("LONE_AB " + json.dumps(lone_ab(args.devices, args.pairs,
                                              device=args.device)),
              flush=True)
        print("LAUNCHES " + json.dumps(kernels.counts()), flush=True)
        return 0
    records = run(args.processes, args.local_devices, args.device,
                  args.timeout)
    print("MHOST " + json.dumps(summary(records, args.processes,
                                        args.local_devices)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
