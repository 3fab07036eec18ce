#!/usr/bin/env python
"""Seeded chaos harness for the PyTorch/CUDA port: composed fault schedules
over real gRPC, judged against a fault-free mirror chain; the sidecar
killed and restarted; a replica of a fleet killed, drained or contended.

The port of ``scripts/chaos_drive.py`` over ``karpenter_tpu_torch``: every
driver has the reference's name and arguments, plus ``backend=`` and
``device=``.  The default is ``backend="tpu"`` on ``device=None``, which
is the CUDA card and raises without one; ``device="cpu"`` runs the same
drivers on the host (the tests), and ``backend="oracle"`` is the
reference's host run.  The chaos server and its fault-free mirror run the
same backend on the same device, so the parity invariant compares two runs
of the same code.

``run_chaos`` — one CHAOS server built under a ``KT_FAULTS`` schedule (8
fault kinds on one seed: transport UNAVAILABLE + reset, mid-step and
mid-commit exceptions, injected step latency, a session-table wipe, a TTL
clock jump, spool corruption and truncation) and one MIRROR server with the
null plane, both behind real gRPC on unix sockets.  A seeded churn chain
drives the chaos session; the driver mirrors every perturbation onto the
mirror session with the same recovery structure (a chaos re-establish is
mirrored as a re-establish of the identical pod list).  After every
recovered step these invariants hold:

1. **No silent divergence** — the chaos client's merged view is
   byte-identical to the chaos server's live chain entry.
2. **Mirror parity** — the chaos view equals the fault-free mirror view
   as a node partition (per-node offering + pod set; node NAMES come from
   a process-global counter and can never match across servers).
3. **Typed errors only** — everything raised through the facade is
   SolveShedError / SolveDeadlineError / SolveRetriesExhausted /
   SolveStepFailed.
4. **Bounded recovery** — full re-establishes <= faults injected + 1
   (the +1 is the initial establishment).

``run_restart`` — a solver sidecar SUBPROCESS (``python -m
karpenter_tpu_torch.service.server``) serving a churn chain is SIGTERM'd
mid-chain and relaunched on the same unix socket.  With ``KT_SESSION_DIR``
the replacement restores the session spool and every client's next delta
is served warm (zero re-establishing full solves); without it, exactly N
clients pay one re-establish each.  The relaunch's wait for health
includes the new process's CUDA context on the card (``relaunch_ready_s``).

``run_fleet`` — N in-process replicas on unix sockets sharing ONE session
spool, ``FleetClient`` session-affinity routing, every chain mirrored onto
a fault-free single replica.  Modes: ``kill`` (hard-kill one of N; the
survivors steal its sessions after the lease TTL and serve them warm),
``drain`` (graceful drain, chains handed off, zero re-establishes),
``kill-cold`` (no spool: exactly one re-establish per orphaned session),
``contend`` (two survivors adopt one dead session at once: exactly one
wins) and ``stale`` (the spool rolled back: exactly one re-establish per
session, never a stale chain served).

``bench_torch.py``'s ``measure_restart_recovery`` and
``measure_fleet_failover`` run these drivers on the card.

Usage::

    python scripts/chaos_drive_torch.py                  # on the card
    python scripts/chaos_drive_torch.py --device cpu --steps 24 --pods 400
    python scripts/chaos_drive_torch.py --restart [--no-snapshot]
    python scripts/chaos_drive_torch.py --fleet --mode drain --seed 24
    python scripts/chaos_drive_torch.py --backend oracle --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TYPED_ERRORS_DOC = ("SolveShedError", "SolveDeadlineError",
                    "SolveRetriesExhausted", "SolveStepFailed")


def _device(device):
    """The drivers' torch device: ``None`` is the card (raising without
    one), anything else as given."""
    from karpenter_tpu_torch.device import resolve_device

    return resolve_device(device)


def _scheduler(backend, device, registry):
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    return BatchScheduler(backend=backend, registry=registry, device=device)


def _close_service(service) -> None:
    """Stop a service, then every scheduler it holds (warm threads, the
    guard's probe)."""
    service.close()
    for sched in list(service._schedulers.values()):
        sched.stop_warms()


def make_pods(n, tag):
    """Unconstrained steady-state churn pods (the bench's warm-start
    shape: 6 deployment families, no topology)."""
    from karpenter_tpu_torch.models.pod import PodSpec

    out = []
    for i in range(n):
        g = i % 6
        out.append(PodSpec(
            name=f"{tag}-{i}", labels={"app": f"ws{g}"},
            requests={"cpu": 0.25 * (1 + g % 3),
                      "memory": (0.5 + g % 4) * 2**30},
            owner_key=f"ws{g}",
        ))
    return out


def canonical(res):
    """Server-independent view of a solution: the node partition (offering
    + sorted pod names per node) + the infeasible set.  Node NAMES come
    from a process-global counter, so cross-server comparison must be
    name-blind."""
    return (
        sorted((n.instance_type, n.zone, n.capacity_type,
                tuple(sorted(p.name for p in n.pods)))
               for n in res.nodes),
        dict(res.infeasible),
    )


def default_schedule(seed: int, steps: int) -> str:
    """8 fault kinds composed on ONE seeded schedule, spread over the
    chain so recoveries interleave (occurrence numbers are per-site:
    transport counts client RPC attempts, session_table counts table
    get/put, delta_step counts applied steps, snapshot_write counts spool
    writes)."""
    mid = max(6, steps // 2)
    late = max(10, (3 * steps) // 4)
    return (
        f"seed={seed};"
        # ride-through: one injected UNAVAILABLE, retried transparently
        f"rpc_unavailable@transport:at=4;"
        # exhaustion: two consecutive attempts fail -> typed give-up
        f"rpc_reset@transport:at=9;rpc_unavailable@transport:at=10;"
        # mid-step + half-mutated commit exceptions -> eviction + typed
        f"dispatch_exc@delta_step:at=6;"
        f"dispatch_exc@delta_commit:at={mid};"
        # injected latency while in_step=True
        f"slow_step@delta_step:at=3:value=0.02;"
        # the table adversaries: wipe + TTL clock jump
        f"session_wipe@session_table:at={mid + 2};"
        f"clock_jump@session_table:at={late}:value=100000;"
        # the spool adversaries (detected at the next restore)
        f"snapshot_corrupt@snapshot_write:at=1;"
        f"snapshot_truncate@snapshot_write:at=3:value=0.4"
    )


def _serve_pair(tmp, pods_n, schedule, session_dir=None, snapshot_s=None,
                backend="tpu", device=None):
    """(mirror, chaos) in-process servers on unix sockets, both on
    ``backend`` and ``device``.  Construction ORDER is the env dance: the
    mirror stack is built with KT_FAULTS unset (null plane), then the
    chaos stack under the schedule — each component captures its fault
    plane and session spool from the env when it is built."""
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.service.server import SolverService, make_server

    def build(sock):
        reg = Registry()
        sched = _scheduler(backend, device, reg)
        service = SolverService(sched, registry=reg)
        # construct the pipeline EAGERLY: the service builds pipelines
        # lazily on first RPC — by which time this harness has restored
        # the environment
        service._pipeline_for(sched)
        srv, _ = make_server(service, host=sock)
        return reg, service, srv

    assert not os.environ.get("KT_FAULTS"), \
        "run the harness from a KT_FAULTS-clean environment"
    o_sock = f"unix:{tmp}/oracle.sock"
    c_sock = f"unix:{tmp}/chaos.sock"
    oracle = build(o_sock)
    saved = {}
    try:
        saved["KT_FAULTS"] = os.environ.pop("KT_FAULTS", None)
        os.environ["KT_FAULTS"] = schedule
        if session_dir is not None:
            saved["KT_SESSION_DIR"] = os.environ.pop("KT_SESSION_DIR", None)
            os.environ["KT_SESSION_DIR"] = session_dir
        if snapshot_s is not None:
            saved["KT_SESSION_SNAPSHOT_S"] = os.environ.pop(
                "KT_SESSION_SNAPSHOT_S", None)
            os.environ["KT_SESSION_SNAPSHOT_S"] = str(snapshot_s)
        chaos = build(c_sock)
    finally:
        for key, old in saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old
    return (oracle, o_sock), (chaos, c_sock)


def run_chaos(seed=42, steps=60, pods_n=1500, churn=6, schedule=None,
              verbose=True, backend="tpu", device=None):
    """The composed-schedule chaos run.  Returns the scoreboard dict;
    raises AssertionError the moment an invariant breaks."""
    from karpenter_tpu_torch.admission import (
        SolveDeadlineError, SolveShedError,
    )
    from karpenter_tpu_torch.metrics import (
        FAULTS_INJECTED, registry as global_reg,
    )
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.service.client import (
        DeltaSession, SolveRetriesExhausted, SolveStepFailed, SolverClient,
    )

    dev = _device(device)
    schedule = schedule or default_schedule(seed, steps)
    catalog = generate_catalog(full=False)
    provs = [Provisioner(name="default").with_defaults()]
    tmp = tempfile.mkdtemp(prefix="kt-chaos-")
    spool = os.path.join(tmp, "spool")
    (oracle, o_sock), (chaos, c_sock) = _serve_pair(
        tmp, pods_n, schedule, session_dir=spool, snapshot_s=0.0001,
        backend=backend, device=dev)
    (o_reg, o_service, o_srv) = oracle
    (c_reg, c_service, c_srv) = chaos
    typed = {k: 0 for k in TYPED_ERRORS_DOC}
    sess = o_sess = None

    def injected_total():
        # server-side sites count into the chaos server's registry;
        # client-side (transport) into the process default — sum both,
        # as a delta against the harness's start
        return (sum(c_reg.counter(FAULTS_INJECTED).values.values())
                + sum(global_reg.counter(FAULTS_INJECTED).values.values()))

    injected_base = injected_total()
    try:
        # the client's plane must see the schedule (transport faults), so
        # it is set for this constructor only
        os.environ["KT_FAULTS"] = schedule
        try:
            c_client = SolverClient(c_sock, timeout=120.0, retries=1,
                                    backoff_s=0.01)
        finally:
            os.environ.pop("KT_FAULTS", None)
        sess = DeltaSession(c_sock, timeout=120.0, client=c_client)
        o_sess = DeltaSession(o_sock, timeout=120.0)
        pods = make_pods(pods_n, "cw")
        sess.solve(list(pods), provs, catalog)
        o_sess.solve(list(pods), provs, catalog)
        rng = random.Random(seed)
        live = [p.name for p in pods]
        cum_add, cum_rm = [], []
        last_resends = sess.full_resends
        checked = 0
        for k in range(steps):
            rm = rng.sample(live, churn)
            rms = set(rm)
            live = [n for n in live if n not in rms]
            add = make_pods(churn, f"cw{k}")
            live += [p.name for p in add]
            try:
                cur = sess.solve_delta(added=add, removed=rm)
            except (SolveShedError, SolveDeadlineError,
                    SolveRetriesExhausted, SolveStepFailed) as err:
                typed[type(err).__name__] += 1
                cum_add += add
                cum_rm += rm
                continue
            # any OTHER exception is an invariant breach and propagates —
            # errors must be typed
            if sess.full_resends > last_resends:
                # the chaos call re-established internally (eviction,
                # wipe, clock jump, mid-step failure on a prior call):
                # mirror the SAME full solve — identical pod list,
                # identical order
                o_sess.solve(list(sess._pods.values()), provs, catalog)
                last_resends = sess.full_resends
            else:
                o_sess.solve_delta(added=cum_add + add, removed=cum_rm + rm)
            cum_add, cum_rm = [], []
            # invariant 1: client view == server chain, byte-identical
            pipe = list(c_service._pipelines.values())[0]
            with pipe._delta_tab._lock:   # direct peek: get() would
                entry = pipe._delta_tab._sessions.get(sess.session_id)
            if entry is not None:         # advance the fault schedule
                assert entry.prev.assignments == cur.assignments, \
                    f"step {k}: client assignments diverged from chain"
                assert entry.prev.infeasible == cur.infeasible, \
                    f"step {k}: client infeasible diverged from chain"
                assert ({n.name: sorted(p.name for p in n.pods)
                         for n in entry.prev.nodes}
                        == {n.name: sorted(p.name for p in n.pods)
                            for n in cur.nodes}), \
                    f"step {k}: client node map diverged from chain"
            # invariant 2: fault-free mirror parity (name-blind partition)
            assert canonical(cur) == canonical(o_sess.result()), \
                f"step {k}: chaos view diverged from the fault-free mirror"
            checked += 1
        injected = injected_total() - injected_base
        # invariant 4: bounded recovery — one fault costs at most one
        # full re-establishing solve
        assert sess.full_resends - 1 <= injected, (
            f"{sess.full_resends - 1} re-establishes for {injected} "
            "injected faults — recovery is not bounded")
        board = {
            "seed": seed, "steps": steps, "pods": pods_n,
            "backend": backend, "device": str(dev),
            "parity_checked_steps": checked,
            "typed_errors": typed,
            "full_resends": sess.full_resends,
            "delta_rpcs": sess.delta_rpcs,
            "faults_injected": int(injected),
            "injected_by_rule": {
                f"{dict(lk).get('kind')}@{dict(lk).get('site')}": v
                for reg in (c_reg, global_reg)
                for lk, v in reg.counter(FAULTS_INJECTED).values.items()
                if v},
        }
        if verbose:
            print("chaos run clean:")
            for key, val in board.items():
                print(f"  {key}: {val}")
        return board
    finally:
        for s in (sess, o_sess):
            if s is not None:
                s.close()
        o_srv.stop(grace=None)
        c_srv.stop(grace=None)
        _close_service(o_service)
        _close_service(c_service)


# ---- kill-and-restart scenario (subprocess server) ----------------------

_SERVE_ARGS = ["-m", "karpenter_tpu_torch.service.server"]

#: the sidecar's shutdown line naming its kernel launches
_LAUNCHES_LINE = "kernel launches: "


def _spawn_server(sock, session_dir, snapshot_s="2", backend="tpu",
                  device=None, *, log):
    """Start the port's sidecar on ``sock`` as a subprocess on ``backend``
    and ``device`` (the card when None), its output going to the file
    ``log`` (read back by :func:`_stop_server`)."""
    env = dict(os.environ)
    env.pop("KT_FAULTS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH", "")) if p)
    if session_dir:
        env["KT_SESSION_DIR"] = session_dir
        env["KT_SESSION_SNAPSHOT_S"] = snapshot_s
    else:
        env.pop("KT_SESSION_DIR", None)
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, *_SERVE_ARGS, "--backend", backend,
             "--device", str(_device(device)), "--host", sock],
            env=env, stdout=out, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT,
        )
    proc.log_path = log
    return proc


def _server_output(proc) -> str:
    with open(proc.log_path) as f:
        return f.read()


def _stop_server(proc, timeout=30):
    """SIGTERM a sidecar, wait for it to drain and exit, and return its
    kernel launch counts (the shutdown line); raises when it did not stop
    cleanly or printed no counts."""
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=timeout)
    out = _server_output(proc)
    counts = [ln[len(_LAUNCHES_LINE):] for ln in out.splitlines()
              if ln.startswith(_LAUNCHES_LINE)]
    if proc.returncode != 0 or not counts:
        raise RuntimeError(f"sidecar exited {proc.returncode} without its "
                           f"kernel counts:\n{out[-2000:]}")
    return json.loads(counts[-1])


def _wait_ready(sock, timeout=60.0):
    from karpenter_tpu_torch.service.client import SolverClient

    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        client = SolverClient(sock, timeout=5.0, retries=0)
        try:
            if client.health(timeout=2.0).ok:
                client.close()
                return
        except Exception as err:  # noqa: BLE001 — startup polling
            last = err
            client.reset()
            time.sleep(0.25)
        finally:
            client.close()
    raise RuntimeError(f"server on {sock} never became healthy: {last}")


def run_restart(pods_n=4000, clients=4, pre_steps=4, post_steps=4, churn=6,
                seed=11, snapshot=True, verbose=True, strict=True,
                backend="tpu", device=None):
    """SIGTERM a serving subprocess mid-chain, relaunch it on the same
    socket, continue every client's chain.  Returns the scoreboard:
    ``extra_resends`` is 0 with a snapshot (every session restored warm)
    and exactly ``clients`` without one.  Both sidecars run ``backend`` on
    ``device`` and stop gracefully; ``server_launches`` holds the kernel
    launches each counted."""
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.service.client import DeltaSession, SolverClient

    dev = _device(device)
    catalog = generate_catalog(full=False)
    provs = [Provisioner(name="default").with_defaults()]
    tmp = tempfile.mkdtemp(prefix="kt-restart-")
    sock = f"unix:{tmp}/solver.sock"
    spool = os.path.join(tmp, "spool") if snapshot else ""
    t_spawn = time.perf_counter()
    proc = _spawn_server(sock, spool, backend=backend, device=dev,
                         log=os.path.join(tmp, "first.log"))
    proc2 = None
    sessions, rngs, lives = [], [], []
    try:
        _wait_ready(sock)
        first_ready_s = time.perf_counter() - t_spawn
        per = pods_n // clients
        for c in range(clients):
            client = SolverClient(sock, timeout=120.0, retries=2,
                                  backoff_s=0.3)
            s = DeltaSession(sock, timeout=120.0, client=client)
            pods = make_pods(per, f"rc{c}")
            s.solve(list(pods), provs, catalog)
            sessions.append(s)
            rngs.append(random.Random(seed + c))
            lives.append([p.name for p in pods])

        def step(c, tag):
            rm = rngs[c].sample(lives[c], churn)
            rms = set(rm)
            lives[c] = [n for n in lives[c] if n not in rms]
            add = make_pods(churn, f"rc{c}{tag}")
            lives[c] += [p.name for p in add]
            return sessions[c].solve_delta(added=add, removed=rm)

        for k in range(pre_steps):
            for c in range(clients):
                step(c, f"a{k}")
        resends_before = [s.full_resends for s in sessions]
        # SIGTERM: graceful — the serve handler drains + snapshots
        t_kill = time.perf_counter()
        launches = [_stop_server(proc)]
        t_relaunch = time.perf_counter()
        proc2 = _spawn_server(sock, spool, backend=backend, device=dev,
                              log=os.path.join(tmp, "second.log"))
        _wait_ready(sock)
        relaunch_ready_s = time.perf_counter() - t_relaunch
        restart_wall_s = time.perf_counter() - t_kill
        # continue every chain through the restarted replica: the retry
        # budget rides through any residual connection raciness
        t0 = time.perf_counter()
        first_delta_ms = []
        for c in range(clients):
            t1 = time.perf_counter()
            step(c, "post0")
            first_delta_ms.append((time.perf_counter() - t1) * 1000.0)
        for k in range(1, post_steps):
            for c in range(clients):
                step(c, f"b{k}")
        post_wall_s = time.perf_counter() - t0
        extra = sum(s.full_resends for s in sessions) - sum(resends_before)
        launches.append(_stop_server(proc2))
        board = {
            "snapshot": snapshot,
            "clients": clients,
            "pods": pods_n,
            "backend": backend, "device": str(dev),
            "extra_resends": extra,
            "restart_wall_s": round(restart_wall_s, 2),
            "first_ready_s": round(first_ready_s, 2),
            "relaunch_ready_s": round(relaunch_ready_s, 2),
            "first_post_delta_ms": [round(v, 2) for v in first_delta_ms],
            "post_chain_wall_s": round(post_wall_s, 2),
            "server_launches": launches,
        }
        if verbose:
            print(f"restart run ({'with' if snapshot else 'WITHOUT'} "
                  "snapshot):")
            for key, val in board.items():
                print(f"  {key}: {val}")
        expect = 0 if snapshot else clients
        if strict:  # bench (strict=False) reports; check_budgets gates
            assert extra == expect, (
                f"expected {expect} post-restart re-establishes, saw "
                f"{extra}")
        return board
    finally:
        for s in sessions:
            try:
                s.close()
            except Exception:  # noqa: BLE001 — teardown
                pass
        for p in (proc, proc2):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=10)


# ---- fleet-failover scenarios --------------------------------------------

def _build_replica(sock, spool, replica, lease_s, snapshot_s, backend="tpu",
                   device=None):
    """One in-process solver replica on ``backend`` and ``device`` with
    its fault/spool config captured from env at construction (the
    _serve_pair env dance)."""
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.service.server import SolverService, make_server

    saved = {}
    env = {"KT_REPLICA_ID": replica}
    if spool:
        env["KT_SESSION_DIR"] = spool
        env["KT_SESSION_SNAPSHOT_S"] = str(snapshot_s)
        env["KT_SESSION_LEASE_S"] = str(lease_s)
    try:
        for key, val in env.items():
            saved[key] = os.environ.pop(key, None)
            os.environ[key] = val
        if not spool:
            saved["KT_SESSION_DIR"] = os.environ.pop("KT_SESSION_DIR", None)
        reg = Registry()
        sched = _scheduler(backend, device, reg)
        service = SolverService(sched, registry=reg)
        pipe = service._pipeline_for(sched)
        srv, _ = make_server(service, host=sock)
    finally:
        for key, old in saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old
    return {"reg": reg, "service": service, "pipe": pipe, "srv": srv,
            "sock": sock, "replica": replica, "alive": True,
            "device": sched.device}


def _hard_kill(rep):
    """The unclean death: the gRPC server stops answering and the
    dispatcher (and with it the periodic snapshot + lease renewal) halts
    — no final spool write, no lease release.  The replica's sessions
    become adoptable only after the lease TTL, exactly like a crashed
    pod on a shared PVC.  On the card the dead replica's last dispatch
    may still be running on its stream: wait for it, so a survivor's
    adoption never races it."""
    rep["srv"].stop(grace=None)
    rep["pipe"]._stop.set()
    rep["pipe"]._thread.join(timeout=10)
    if rep["device"].type == "cuda":
        import torch

        torch.cuda.synchronize(rep["device"])
    rep["alive"] = False


def _settle_spool(reps, deadline_s=10.0):
    """Wait until every live session's spool record is at its chain's
    committed epoch (the periodic writer runs on idle ticks; a HARD kill
    right after a step may lose the last write — bounded by design, but
    the warm-failover scenarios measure the steady state, where the
    record IS current)."""
    from karpenter_tpu_torch.service import snapshot as snap

    deadline = time.time() + deadline_s
    while time.time() < deadline:
        behind = 0
        for rep in reps:
            if not rep["alive"]:
                continue
            tab = rep["pipe"]._delta_tab
            spool = rep["pipe"]._spool_dir
            if tab is None or not spool:
                continue
            with tab._lock:
                live = {sid: e.epoch for sid, e in tab._sessions.items()}
            for sid, epoch in live.items():
                blob = snap.read_record(spool, sid)
                if blob is None:
                    behind += 1
                    continue
                try:
                    raw, _ = snap.unpack(blob)
                    if int(snap.unpack_entry(raw[0])["epoch"]) != epoch:
                        behind += 1
                except snap.SnapshotRefused:
                    behind += 1
        if behind == 0:
            return
        time.sleep(0.05)
    raise RuntimeError("session spool never settled to the live epochs")


def run_fleet(replicas=3, clients=6, pods_n=1200, pre_steps=3, post_steps=3,
              churn=4, seed=23, mode="kill", lease_s=0.4, verbose=True,
              strict=True, backend="tpu", device=None):
    """One fleet-failover scenario (see the module docstring's mode
    catalog), every replica and the mirror on ``backend`` and ``device``.
    Returns the scoreboard; raises AssertionError the moment an invariant
    breaks (strict=True)."""
    import threading

    from karpenter_tpu_torch.admission import (
        SolveDeadlineError, SolveShedError,
    )
    from karpenter_tpu_torch.analysis import conformance
    from karpenter_tpu_torch.metrics import SESSION_ADOPTIONS
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.obs import protocol
    from karpenter_tpu_torch.service import snapshot as snap
    from karpenter_tpu_torch.service.client import (
        DeltaSession, FleetClient, SolveRetriesExhausted, SolveStepFailed,
        SolverDraining,
    )

    assert mode in ("kill", "drain", "kill-cold", "contend", "stale"), mode
    dev = _device(device)
    spooled = mode != "kill-cold"
    catalog = generate_catalog(full=False)
    provs = [Provisioner(name="default").with_defaults()]
    tmp = tempfile.mkdtemp(prefix="kt-fleet-")
    spool = os.path.join(tmp, "spool") if spooled else ""
    reps = []
    oracle = None
    sessions = []
    # conformance tap: every replica is in-process, so one process-global
    # recorder sees the whole fleet's protocol transitions; the checker
    # asserts each session's observed sequence is a path of the
    # model-checked automaton
    rec = protocol.TransitionRecorder()
    prev_sink = protocol.installed()
    protocol.install(rec)
    try:
        for i in range(replicas):
            reps.append(_build_replica(f"unix:{tmp}/r{i}.sock", spool,
                                       f"replica-{i}", lease_s, 0.0001,
                                       backend, dev))
        oracle = _build_replica(f"unix:{tmp}/oracle.sock", "", "oracle",
                                1.0, 0, backend, dev)
        socks = [r["sock"] for r in reps]
        typed = {k: 0 for k in
                 TYPED_ERRORS_DOC + ("SolverDraining", "LeaseHeld")}
        rng = random.Random(seed)
        per = max(20, pods_n // clients)
        for c in range(clients):
            fc = FleetClient(socks, timeout=120.0, retries=1,
                             backoff_s=0.02)
            sess = DeltaSession(socks[0], timeout=120.0, client=fc)
            mirror = DeltaSession(oracle["sock"], timeout=120.0)
            pods = make_pods(per, f"fl{c}")
            sess.solve(list(pods), provs, catalog)
            mirror.solve(list(pods), provs, catalog)
            sessions.append({
                "fc": fc, "sess": sess, "mirror": mirror,
                "live": [p.name for p in pods],
                "cum_add": [], "cum_rm": [],
                "resends": sess.full_resends,
            })

        def step(s, tag):
            """One churn step + mirror + parity check.  Returns False
            when the step surfaced a typed error (perturbation stays
            pending, cumulative retry next call)."""
            rm = rng.sample(s["live"], min(churn, len(s["live"])))
            rms = set(rm)
            s["live"] = [n for n in s["live"] if n not in rms]
            add = make_pods(churn, tag)
            s["live"] += [p.name for p in add]
            try:
                cur = s["sess"].solve_delta(added=add, removed=rm)
            except (SolveShedError, SolveDeadlineError,
                    SolveRetriesExhausted, SolveStepFailed,
                    SolverDraining) as err:
                typed[type(err).__name__] += 1
                s["cum_add"] += add
                s["cum_rm"] += rm
                return False
            if s["sess"].full_resends > s["resends"]:
                # the chain re-established internally: mirror the SAME
                # full solve so both sides see identical sequences
                s["mirror"].solve(list(s["sess"]._pods.values()), provs,
                                  catalog)
                s["resends"] = s["sess"].full_resends
            else:
                s["mirror"].solve_delta(added=s["cum_add"] + add,
                                        removed=s["cum_rm"] + rm)
            s["cum_add"], s["cum_rm"] = [], []
            assert canonical(cur) == canonical(s["mirror"].result()), \
                f"{tag}: fleet view diverged from the fault-free mirror"
            return True

        for k in range(pre_steps):
            for c, s in enumerate(sessions):
                step(s, f"fl{c}a{k}")
        if spooled:
            _settle_spool(reps)
        # the victim: the replica serving the most sessions (rendezvous
        # picks it deterministically per seed via the session ids)
        by_ep = {r["sock"]: [] for r in reps}
        for s in sessions:
            by_ep[s["fc"].endpoint_for(s["sess"].session_id)].append(s)
        victim = max(reps, key=lambda r: len(by_ep[r["sock"]]))
        victim_sessions = by_ep[victim["sock"]]
        n_victim = len(victim_sessions)
        resends_before = sum(s["sess"].full_resends for s in sessions)

        if mode in ("kill", "kill-cold", "contend", "stale"):
            if mode == "stale":
                # snapshot the CURRENT records (file-by-file: survivors
                # are live writers, so temp files come and go under any
                # tree walk), then advance the chains so the on-disk
                # state rolled back to is genuinely stale.  The pipeline
                # namespaces its spool per backend.
                import shutil

                rec_dir = os.path.join(spool, backend, snap.SESSIONS_SUBDIR)
                stale_dir = os.path.join(tmp, "stale-copy")
                os.makedirs(stale_dir, exist_ok=True)
                for name in os.listdir(rec_dir):
                    if not name.endswith(snap.RECORD_SUFFIX):
                        continue
                    try:
                        shutil.copyfile(os.path.join(rec_dir, name),
                                        os.path.join(stale_dir, name))
                    except FileNotFoundError:
                        pass  # consumed/replaced mid-copy
                for k in range(2):
                    for c, s in enumerate(sessions):
                        step(s, f"fl{c}s{k}")
                _settle_spool(reps)
            _hard_kill(victim)
            if mode == "stale":
                # roll the RECORDS back in place (the PVC-restore
                # adversary): every record is now at a PRE-advance epoch,
                # replaced file-by-file — never an rmtree under a live
                # writer
                for name in os.listdir(stale_dir):
                    t = os.path.join(rec_dir, name + ".stale-tmp")
                    shutil.copyfile(os.path.join(stale_dir, name), t)
                    os.replace(t, os.path.join(rec_dir, name))
            if spooled:
                # leases stop renewing at death; adoption is legal (as a
                # counted STEAL) only after the TTL
                time.sleep(lease_s + 0.3)
        elif mode == "drain":
            victim["service"].drain()

        contention = None
        if mode == "contend":
            # two survivors race to adopt the SAME dead session directly
            # (the client would only ever ask one): exactly one may win
            survivors = [r for r in reps if r["alive"]][:2]
            sid = victim_sessions[0]["sess"].session_id \
                if victim_sessions else sessions[0]["sess"].session_id
            results = {}
            barrier = threading.Barrier(len(survivors))

            def refusals():
                return {k: sum(r["reg"].counter(SESSION_ADOPTIONS).get(
                    {"outcome": k}) for r in reps)
                    for k in ("lease_held", "missing")}

            before = refusals()

            def adopt(rep):
                barrier.wait()
                tab = rep["pipe"]._delta_tab
                results[rep["replica"]] = tab.adopt(
                    rep["pipe"]._spool_dir, sid)

            threads = [threading.Thread(target=adopt, args=(r,))
                       for r in survivors]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            winners = [k for k, v in results.items() if v is not None]
            assert len(winners) == 1, (
                f"lease contention yielded {len(winners)} adopters "
                f"(want exactly 1): {results}")
            # the loser refuses, counted: on the winner's live lease, or
            # on the record the winner already consumed when the loser's
            # thread runs only after the winner's whole adoption (a
            # loaded host); exactly one refusal either way
            refused = {k: int(v - before[k])
                       for k, v in refusals().items()}
            assert sum(refused.values()) == 1, (
                f"the losing adopter was not counted: {refused}")
            typed["LeaseHeld"] += refused["lease_held"]
            contention = refused

        # continue every chain through the fleet
        post_ok = 0
        for k in range(post_steps):
            for c, s in enumerate(sessions):
                if step(s, f"fl{c}b{k}"):
                    post_ok += 1
        extra = sum(s["sess"].full_resends for s in sessions) \
            - resends_before

        if spooled:
            # let zombie reconciliation land before the audit: a replica
            # holding a stale adopted entry drops it (lease_lost) on its
            # next periodic snapshot pass
            time.sleep(0.4)
        # single-owner audit: every session lives in AT MOST one serving
        # replica's table
        multi_owner = []
        for s in sessions:
            sid = s["sess"].session_id
            holders = []
            for rep in reps:
                if not rep["alive"]:
                    continue
                tab = rep["pipe"]._delta_tab
                with tab._lock:
                    if sid in tab._sessions:
                        holders.append(rep["replica"])
            if len(holders) > 1:
                multi_owner.append((sid, holders))
        assert not multi_owner, \
            f"sessions served by multiple replicas: {multi_owner}"

        adoptions = {}
        for rep in reps:
            for lk, v in rep["reg"].counter(
                    SESSION_ADOPTIONS).values.items():
                if v:
                    key = dict(lk).get("outcome", "")
                    adoptions[key] = adoptions.get(key, 0) + int(v)
        report = conformance.check_events(rec.events_by_session())
        board = {
            "mode": mode, "seed": seed, "replicas": replicas,
            "clients": clients, "pods": per * clients,
            "backend": backend, "device": str(dev),
            "victim": victim["replica"],
            "victim_sessions": n_victim,
            "extra_resends": extra,
            "post_steps_served": post_ok,
            "typed_errors": {k: v for k, v in typed.items() if v},
            "adoptions": adoptions,
            **({"contention_refusals": contention} if contention else {}),
            "conformance": {"sessions": report.sessions,
                            "events": report.events,
                            "violations": len(report.violations)},
        }
        if verbose:
            print(f"fleet {mode} run clean:")
            for key, val in board.items():
                print(f"  {key}: {val}")
        if strict:
            assert report.ok, report.format()
            if mode in ("kill", "drain"):
                assert extra == 0, (
                    f"{extra} re-establishing solve(s) on the warm "
                    f"failover path (mode={mode}; want ZERO — the spool "
                    "must hand every chain off warm)")
                if mode == "kill" and n_victim:
                    stolen = adoptions.get("stolen", 0)
                    assert stolen >= n_victim, (
                        f"only {stolen} steal-adoptions for {n_victim} "
                        "orphaned sessions")
            elif mode == "kill-cold":
                assert extra == n_victim, (
                    f"{extra} re-establishes for {n_victim} orphaned "
                    "sessions without a spool — the cold path must cost "
                    "exactly one per session")
            elif mode == "contend":
                # at most ONE re-establish (only when the probe's winner
                # was not the endpoint the client routes to)
                assert extra <= 1, (
                    f"{extra} re-establishes after one contended "
                    "adoption — contention must cost at most one")
            elif mode == "stale":
                assert extra == n_victim, (
                    f"{extra} re-establishes for {n_victim} stale-spool "
                    "sessions — stale adoption must cost exactly one "
                    "re-establish each, never serve the stale chain")
        return board
    finally:
        protocol.install(prev_sink)
        for s in sessions:
            try:
                s["sess"].close()
                s["mirror"].close()
            except Exception:  # noqa: BLE001 — teardown
                pass
        for rep in reps + ([oracle] if oracle else []):
            try:
                rep["srv"].stop(grace=None)
                _close_service(rep["service"])
            except Exception:  # noqa: BLE001 — teardown
                pass


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--pods", type=int, default=1500)
    ap.add_argument("--churn", type=int, default=6)
    ap.add_argument("--schedule", default=None,
                    help="override the composed KT_FAULTS schedule")
    ap.add_argument("--backend", default="tpu", choices=["tpu", "auto", "oracle"],
                    help="the servers' scheduler backend (default tpu, the "
                         "device path; oracle is the host FFD)")
    ap.add_argument("--device", default=None,
                    help="torch device the servers run on (default the "
                         "CUDA card, raising without one; 'cpu' runs on "
                         "the host)")
    ap.add_argument("--restart", action="store_true",
                    help="run the kill-and-restart scenario instead")
    ap.add_argument("--no-snapshot", action="store_true",
                    help="(--restart) run WITHOUT KT_SESSION_DIR: every "
                         "client pays one re-establish")
    ap.add_argument("--fleet", action="store_true",
                    help="run a fleet-failover scenario (N replicas, one "
                         "shared session spool, fleet-aware clients)")
    ap.add_argument("--mode", default="kill",
                    choices=["kill", "drain", "kill-cold", "contend",
                             "stale"],
                    help="(--fleet) scenario: hard kill-one-of-N (warm "
                         "steal), graceful drain-one-of-N, the no-spool "
                         "cold baseline, concurrent lease contention, or "
                         "stale-spool adoption")
    ap.add_argument("--replicas", type=int, default=3)
    args = ap.parse_args(argv)
    where = dict(backend=args.backend, device=args.device)
    if args.fleet:
        run_fleet(replicas=args.replicas, seed=args.seed, mode=args.mode,
                  **where)
    elif args.restart:
        run_restart(snapshot=not args.no_snapshot, **where)
    else:
        run_chaos(seed=args.seed, steps=args.steps, pods_n=args.pods,
                  churn=args.churn, schedule=args.schedule, **where)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
