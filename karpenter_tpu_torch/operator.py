"""Operator runtime — process bootstrap, controller wiring, run loop: the
port of the reference package's ``operator.py``.

The cmd/controller/main.go + core operator.NewOperator analog (SURVEY.md
§3.1): builds the cloud provider, wraps it in the metrics decorator, registers
every controller, exposes /metrics and /healthz over HTTP, and drives the
reconcile loops.  Leader election is LEASE-based (the coordination.k8s.io
Lease analog — reference settings.md:23, LEADER_ELECT): replicas contend on
a pluggable LeaseStore, the holder renews every tick, a standby acquires
when the lease expires, and leadership gates cache hydration exactly like
launchtemplate.go:77-88 — hydration re-runs on every (re-)election, which is
the resume-from-cloud-state posture (SURVEY §5 checkpoint/resume).

The port's differences: an in-process operator (no ``solver_address``)
builds its ``BatchScheduler`` on ``device`` — the CUDA card by default,
raising without one, or ``"cpu"`` when asked.  A remote operator
(``solver_address`` set, the deployed topology) solves on the sidecar and
touches no card itself: its ``RemoteScheduler`` keeps an oracle fallback
on the host CPU, so it runs on a node without CUDA.

Run a self-contained simulation:  ``python -m karpenter_tpu_torch.operator
--demo`` (``--device cpu`` on a host without a card).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from .batcher import Window
from .cache import UnavailableOfferings
from .cloud.base import CloudProvider
from .cloud.fake import FakeCloudProvider
from .controllers.deprovisioning import DeprovisioningController
from .controllers.garbagecollect import GarbageCollectController, LinkController
from .controllers.interruption import InterruptionController, MessageQueue
from .controllers.nodetemplate import NodeTemplateController
from .controllers.provisioning import ProvisioningController
from .controllers.state import ClusterState
from .controllers.termination import TerminationController
from .events import Recorder
from .metrics import Registry, decorate, registry as default_registry
from .models.catalog import generate_catalog
from .models.pod import PodSpec
from .models.provisioner import Provisioner
from .obs import FlightRecorder, Tracer
from .obs import export as obs_export
from .providers.pricing import PricingProvider
from .providers.securitygroup import SecurityGroupProvider
from .providers.subnet import SubnetProvider
from .settings import Settings, SettingsStore
from .solver.scheduler import BatchScheduler
from .utils.clock import Clock


@dataclass
class Lease:
    """One leadership lease record (coordination.k8s.io/Lease analog)."""

    holder: str
    renewed_at: float
    ttl: float

    def expired(self, now: float) -> bool:
        return now >= self.renewed_at + self.ttl


class InMemoryLeaseStore:
    """Pluggable lease store.  Contending Operator replicas share one store;
    a real deployment plugs a kube-API-backed implementation with the same
    two-method surface.  ``try_acquire`` is atomic: it renews for the current
    holder, grants an unheld/expired lease, and refuses a live one."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._leases: dict = {}

    def get(self, name: str) -> Optional[Lease]:
        with self._lock:
            return self._leases.get(name)

    def try_acquire(self, name: str, holder: str, ttl: float, now: float) -> bool:
        with self._lock:
            cur = self._leases.get(name)
            if cur is not None and cur.holder != holder and not cur.expired(now):
                return False
            self._leases[name] = Lease(holder, now, ttl)
            return True

    def release(self, name: str, holder: str) -> None:
        with self._lock:
            cur = self._leases.get(name)
            if cur is not None and cur.holder == holder:
                del self._leases[name]


def _default_identity() -> str:
    """Unique per elector instance ACROSS processes: two replicas sharing a
    real (pluggable) lease store must never collide on a default identity,
    or try_acquire would grant both (holder == holder) and split-brain."""
    import uuid

    return f"operator-{uuid.uuid4().hex[:8]}"


class LeaderElector:
    """Lease-based leadership (operator.Elected() analog, settings.md:23).

    Each tick the elector tries to acquire-or-renew the lease: the holder
    stays elected, a standby takes over once the lease TTL lapses without a
    renewal (leader crashed / partitioned), and a deposed holder steps down.
    ``on_elected`` callbacks fire on every False->True transition — i.e. on
    takeover too, so hydration re-runs and the new leader resumes from cloud
    state.  ``elect`` (optional) is an extra gate retained for tests."""

    DEFAULT_TTL = 15.0

    def __init__(
        self,
        elect: Optional[Callable[[], bool]] = None,
        *,
        identity: Optional[str] = None,
        store: Optional[InMemoryLeaseStore] = None,
        lease_name: str = "karpenter-tpu-leader",
        lease_ttl: float = DEFAULT_TTL,
        clock: Optional[Clock] = None,
    ) -> None:
        self._elect = elect
        self.identity = identity or _default_identity()
        self.store = store or InMemoryLeaseStore()
        self.lease_name = lease_name
        self.lease_ttl = lease_ttl
        self.clock = clock or Clock()
        self.elected = False
        self._on_elected: List[Callable[[], None]] = []

    def on_elected(self, fn: Callable[[], None]) -> None:
        self._on_elected.append(fn)

    def tick(self) -> bool:
        if self._elect is not None and not self._elect():
            # gate closed: step down AND release the lease so a healthy
            # standby takes over immediately instead of waiting out the TTL
            self.resign()
            return False
        won = self.store.try_acquire(
            self.lease_name, self.identity, self.lease_ttl, self.clock.now()
        )
        if won and not self.elected:
            self.elected = True
            for fn in self._on_elected:
                fn()
        elif not won:
            self.elected = False  # deposed: stop reconciling immediately
        return self.elected

    def resign(self) -> None:
        """Release the lease (clean shutdown / gate-down) so a standby takes
        over without waiting out the TTL.  Safe to call when not holding —
        the store only deletes a lease naming this identity."""
        self.store.release(self.lease_name, self.identity)
        self.elected = False


class Operator:
    def __init__(
        self,
        cloud: CloudProvider,
        clock: Optional[Clock] = None,
        settings: Optional[SettingsStore] = None,
        registry: Optional[Registry] = None,
        scheduler_backend: str = "auto",
        metrics_port: int = 0,  # 0 disables the HTTP server
        lease_store: Optional[InMemoryLeaseStore] = None,
        identity: Optional[str] = None,
        solver_address: str = "",  # host:port of a solver sidecar; "" = in-process
        device=None,  # in-process scheduler's torch device (None: the card)
    ) -> None:
        self.clock = clock or Clock()
        self.settings = settings or SettingsStore()
        self.registry = registry or default_registry
        # observability spine (docs/OBSERVABILITY.md): one tracer + flight
        # recorder per operator, on the operator's clock/registry; events
        # feed the flight recorder's ring so anomaly dumps carry them
        self.flight = FlightRecorder(clock=self.clock, registry=self.registry)
        self.tracer = Tracer(clock=self.clock, registry=self.registry,
                             flight=self.flight)
        self.recorder = Recorder(sink=self.flight.add_event)
        self.elector = LeaderElector(
            identity=identity, store=lease_store, clock=self.clock
        )
        self.metrics_port = metrics_port

        self.state = ClusterState(clock=self.clock)
        # request coalescing under the metrics decorator, like the
        # reference's pkg/batcher sits inside the provider under
        # core's metrics.Decorate (cmd/controller/main.go:46).
        # idle_seconds=0: the operator tick is single-threaded, so waiting
        # for peers would only add dead latency; coalescing engages for
        # concurrent callers (e.g. the gRPC solver service threads).
        from .cloud.batched import BatchedCloud

        self.cloud = decorate(BatchedCloud(cloud, idle_seconds=0.0), self.registry)
        self.cloud.configure_settings(self.settings.current)
        self.unavailable = UnavailableOfferings(clock=self.clock)
        if solver_address:
            # split topology (deploy/operator.yaml + deploy/solver.yaml): the
            # sidecar owns tensorization + the device mesh; this process only
            # reconciles.  The reference consumes its remote boundary the
            # same way (cmd/controller/main.go:44).  Falls back to a local
            # oracle solve on the host CPU while the sidecar is unreachable
            # (``device`` is the sidecar's business: it is not used here).
            from .admission import CRITICAL
            from .service.client import RemoteScheduler

            deadline_ms = float(
                os.environ.get("KT_SOLVER_DEADLINE_MS", "0") or 0.0)
            self.scheduler = RemoteScheduler(
                solver_address,
                backend="" if scheduler_backend == "auto" else scheduler_backend,
                registry=self.registry,
                # the provisioning reconcile loop is the service's highest
                # class: never shed while lower classes can absorb, fills
                # megabatch slots first (docs/ADMISSION.md)
                priority=CRITICAL,
                deadline_s=(deadline_ms / 1000.0) if deadline_ms > 0 else None,
                # availability first: the reconcile loop has no backoff
                # story, so a (rare) shed of critical traffic is logged
                # and served from the local fallback instead of raising
                # through tick() and killing the operator
                shed_fallback=True,
            )
        else:
            self.scheduler = BatchScheduler(backend=scheduler_backend,
                                            registry=self.registry,
                                            tracer=self.tracer,
                                            device=device)
        s = self.settings.current
        self.pricing = PricingProvider(
            cloud.get_instance_types(), clock=self.clock,
            isolated_vpc=s.isolated_vpc,
        )
        self.subnets = SubnetProvider()
        self.security_groups = SecurityGroupProvider(clock=self.clock)
        self.queue = MessageQueue()
        self.provisioning = ProvisioningController(
            self.state, self.cloud, scheduler=self.scheduler, recorder=self.recorder,
            registry=self.registry, unavailable=self.unavailable, clock=self.clock,
            idle_seconds=s.batch_idle_duration, max_seconds=s.batch_max_duration,
            tracer=self.tracer,
        )
        self.termination = TerminationController(
            self.state, self.cloud, recorder=self.recorder,
            registry=self.registry, clock=self.clock,
        )
        self.deprovisioning = DeprovisioningController(
            self.state, self.cloud, self.termination, provisioning=self.provisioning,
            scheduler=self.scheduler, recorder=self.recorder, registry=self.registry,
            clock=self.clock, drift_enabled=s.drift_enabled,
            deprovisioning_ttl=s.deprovisioning_ttl,
            tracer=self.tracer,
        )
        self.interruption = InterruptionController(
            self.state, self.termination, self.queue, unavailable=self.unavailable,
            recorder=self.recorder, registry=self.registry, clock=self.clock,
        )
        self.gc = GarbageCollectController(self.state, self.cloud, recorder=self.recorder, clock=self.clock)
        self.link = LinkController(self.state, self.cloud, recorder=self.recorder, clock=self.clock)
        self.nodetemplates = NodeTemplateController(self.subnets, self.security_groups, clock=self.clock)

        self.settings.subscribe(self._on_settings)
        self.elector.on_elected(self._hydrate)
        self._http: Optional[ThreadingHTTPServer] = None
        self._stop = threading.Event()
        #: serializes the reconcile tick against HTTP-thread config applies
        self._reconcile_lock = threading.RLock()

    # ---- wiring ---------------------------------------------------------
    def _on_settings(self, s: Settings) -> None:
        self.cloud.configure_settings(s)
        self.provisioning.window = Window(
            s.batch_idle_duration, s.batch_max_duration, clock=self.clock
        )
        self.deprovisioning.drift_enabled = s.drift_enabled
        self.deprovisioning.deprovisioning_ttl = s.deprovisioning_ttl
        self.pricing.isolated_vpc = s.isolated_vpc
        if self.elector.elected:
            # settings can reshape the catalog (pod density, pod-ENI) and
            # thus the solver tensor shapes: re-warm the shape ladder
            self._warm_solver()

    def _hydrate(self) -> None:
        """Leadership-gated warm-state rebuild (SURVEY §5 checkpoint/resume):
        re-adopt orphaned instances, refresh prices, and start the solver
        shape warmup so the first real batches find their shapes warmed
        (a shape outside the warmed ladder runs on its first call)."""
        self.link.reconcile()
        self.pricing.maybe_refresh()
        self._warm_solver()

    def _warm_solver(self, wait: bool = False) -> None:
        provs = [p.with_defaults() for p in self.state.provisioners.values()]
        # in-process schedulers warm the full bucket grid (single-solve
        # ladder + megabatch slot rungs); the RemoteScheduler facade only
        # has warm_startup — the sidecar owns its own rungs (serve --warmup)
        warm = getattr(self.scheduler, "precompile_buckets", None)
        kwargs = {} if warm is None else {"wait": wait}
        try:
            (warm or self.scheduler.warm_startup)(
                provs or [Provisioner(name="default").with_defaults()],
                self.cloud.get_instance_types(),
                daemonsets=self.state.daemonsets,
                existing_nodes=[n.snapshot()
                                for n in self.state.schedulable_nodes()],
                **kwargs,
            )
        except Exception:  # warmup is best-effort; solves fall back warm
            logging.getLogger(__name__).warning(
                "solver warmup failed; solves run unwarmed", exc_info=True
            )

    # ---- declarative config / admission ---------------------------------
    def apply_manifests(self, path) -> tuple:
        """Load YAML manifests (file or directory) through admission into
        the operator: Provisioners + NodeTemplates + global settings.
        Raises AdmissionError on any invalid document."""
        from .manifests import apply_path

        # attribute access passes through the metrics decorator and the
        # batching wrapper to the real provider (tests: provider attrs
        # pass through), so .templates reaches the provider's dict
        with self._reconcile_lock:
            return apply_path(
                path, state=self.state, cloud=self.cloud,
                settings_store=self.settings,
            )

    def admit_http(self, raw_body: str, *, apply: bool = False):
        """One admission review over HTTP: parse the YAML/JSON body, run it
        through the webhook layer, return (http_status, response_dict) with
        a structured allow/deny — the knative admission-response analog."""
        import yaml as _yaml

        from .manifests import admit_documents
        from .webhooks import AdmissionError

        try:
            docs = [d for d in _yaml.safe_load_all(raw_body) if d]
        except _yaml.YAMLError as err:
            return 400, {"allowed": False,
                         "errors": [f"unparseable document: {err}"]}
        if not docs:
            return 400, {"allowed": False, "errors": ["empty request body"]}
        try:
            provs, templates, overrides, storage = admit_documents(
                docs, current_settings=self.settings.current
            )
        except AdmissionError as err:
            return 422, {"allowed": False, "kind": err.kind,
                         "name": err.name, "errors": err.errors}
        if not provs and not templates and not overrides and not storage:
            kinds = sorted({str(d.get("kind", "?")) for d in docs})
            return 400, {"allowed": False,
                         "errors": [f"no recognized documents (kinds: {kinds})"]}
        if apply:
            from .manifests import apply_objects

            try:
                # under the reconcile lock: the HTTP worker thread must not
                # mutate state dicts mid-tick (dictionary-changed-size), and
                # a tick must never observe a half-applied config
                with self._reconcile_lock:
                    apply_objects(provs, templates, overrides, storage,
                                  state=self.state, cloud=self.cloud,
                                  settings_store=self.settings)
            except AdmissionError as err:
                return 422, {"allowed": False, "kind": err.kind,
                             "name": err.name, "errors": err.errors}
        return 200, {
            "allowed": True,
            "admitted": {
                "provisioners": [p.name for p in provs],
                "node_templates": [t.name for t in templates],
                "settings_keys": sorted(overrides),
                "storage_objects": [getattr(s, "name", "?") for s in storage],
            },
            "applied": bool(apply),
        }

    # ---- health / metrics -----------------------------------------------
    def healthz(self) -> bool:
        return self.cloud.liveness() and self.pricing.liveness_ok()

    def start_http(self) -> Optional[int]:
        if self.metrics_port == 0:
            return None
        op = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence
                pass

            def do_GET(self):
                ctype = None
                if self.path == "/metrics":
                    body = op.registry.expose().encode()
                    self.send_response(200)
                elif self.path == "/healthz":
                    ok = op.healthz()
                    body = (b"ok" if ok else b"unhealthy")
                    self.send_response(200 if ok else 503)
                elif self.path.startswith("/tracez"):
                    # recent traces + per-span p50/p99 (obs/export.py)
                    body = json.dumps(obs_export.tracez(op.flight),
                                      default=str).encode()
                    ctype = "application/json"
                    self.send_response(200)
                elif self.path.startswith("/statusz"):
                    body = json.dumps(
                        obs_export.statusz(op.registry, op.flight),
                        default=str).encode()
                    ctype = "application/json"
                    self.send_response(200)
                elif self.path.startswith("/fleetz"):
                    # fleet-merged view (obs/fleet.py): fans out
                    # to the solver replicas' obs endpoints (KT_OBS_PEERS)
                    # and merges load/ownership/trace trees — the operator
                    # mounts the same document the solver sidecars serve,
                    # with ITS hops (the "remote" spans the reconciler
                    # cut) contributed from memory
                    from .obs import fleet as obs_fleet

                    body = json.dumps(
                        obs_fleet.fleetz(obs_fleet.env_peers(),
                                         local=(op.registry, op.flight,
                                                None)),
                        default=str).encode()
                    ctype = "application/json"
                    self.send_response(200)
                else:
                    body = b"not found"
                    self.send_response(404)
                if ctype:
                    self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                # admission endpoints (the knative webhook-server analog,
                # pkg/webhooks/webhooks.go:33-63): POST a YAML/JSON manifest,
                # get a structured allow/deny.  /admission/validate judges
                # only; /admission/apply admits AND applies to the operator.
                if self.path not in ("/admission/validate", "/admission/apply"):
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(length).decode()
                except (ValueError, UnicodeDecodeError) as err:
                    status, body = 400, {"allowed": False,
                                         "errors": [f"unreadable body: {err}"]}
                else:
                    status, body = op.admit_http(
                        raw, apply=self.path.endswith("/apply")
                    )
                payload = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._http = ThreadingHTTPServer(("127.0.0.1", self.metrics_port), Handler)
        port = self._http.server_address[1]
        threading.Thread(target=self._http.serve_forever, daemon=True).start()
        return port

    def stop_http(self) -> None:
        if self._http:
            self._http.shutdown()
            self._http = None

    # ---- loop -----------------------------------------------------------
    def tick(self) -> None:
        """One pass over every controller (singleton-controller semantics)."""
        with self._reconcile_lock:
            self._tick_locked()

    def _tick_locked(self) -> None:
        if not self.elector.tick():
            return
        if self.settings.current.interruption_queue_name:
            # interruption handling is enabled iff a queue is configured
            # (settings.md; pkg/controllers/controllers.go gates the same way)
            self.interruption.reconcile()
        self.provisioning.reconcile()
        self.deprovisioning.reconcile()
        self.termination.reconcile()
        self.nodetemplates.reconcile()
        self.gc.reconcile()
        self.pricing.maybe_refresh()

    def run(self, interval: float = 1.0, max_ticks: Optional[int] = None) -> None:
        n = 0
        while not self._stop.is_set():
            self.tick()
            n += 1
            if max_ticks is not None and n >= max_ticks:
                break
            self.clock.sleep(interval)

    def shutdown(self) -> None:
        self._stop.set()
        # under the reconcile lock: an in-flight tick on another thread must
        # not re-acquire the lease right after the resign (the lock orders
        # resign after that tick; _stop stops any further ones)
        with self._reconcile_lock:
            self.elector.resign()  # standby takes over without waiting the TTL
        self.scheduler.stop_warms()  # don't drain queued warms at exit
        close = getattr(self.scheduler, "close", None)
        if close is not None:  # RemoteScheduler: release the gRPC channel
            close()
        self.stop_http()


def _demo(args) -> None:
    """Self-contained scale-up/scale-down simulation against the fake cloud."""
    from .utils.clock import FakeClock

    clock = FakeClock()
    cloud = FakeCloudProvider(generate_catalog(full=not args.small), clock=clock)
    op = Operator(cloud, clock=clock, scheduler_backend=args.backend,
                  metrics_port=args.metrics_port,
                  solver_address=getattr(args, "solver_address", ""),
                  device=getattr(args, "device", None))
    port = op.start_http()
    if port:
        print(f"metrics on http://127.0.0.1:{port}/metrics")
    if getattr(args, "config", None):
        # declarative scenario: every Provisioner/NodeTemplate/setting comes
        # from YAML through admission — nothing constructed in code
        # apply_path returns four lists (storage objects last); the
        # reference's demo unpacks three and raises here
        provs, templates, overrides, _storage = op.apply_manifests(
            args.config)
        print(f"manifests: {len(provs)} provisioner(s), "
              f"{len(templates)} node template(s), "
              f"{len(overrides)} setting override(s) admitted from {args.config}")
    else:
        op.state.apply_provisioner(
            Provisioner(name="default", consolidation_enabled=True)
        )
    if getattr(args, "warmup", False):
        # blocking bucket-grid warm before traffic: the demo's first
        # solves then meet warmed shapes
        print("warmup: blocking bucket-grid warm...")
        op._warm_solver(wait=True)

    print(f"scale-up: {args.pods} pods")
    for i in range(args.pods):
        op.state.add_pod(PodSpec(
            name=f"pod-{i}", requests={"cpu": 0.5 + (i % 4) * 0.5}, owner_key=f"d{i%5}",
        ))
    for _ in range(4):
        op.tick()
        clock.advance(1.0)
    cost = sum(ns.node.price for ns in op.state.nodes.values())
    print(f"  -> {len(op.state.nodes)} nodes, ${cost:.2f}/hr, "
          f"pending={len(op.state.pending_pods())}")

    print("scale-down: deleting 70% of pods")
    for i in range(0, int(args.pods * 0.7)):
        op.state.delete_pod(f"pod-{i}")
    clock.advance(6 * 60)
    # enough sim time for propose -> 15s validation TTL -> execute cycles
    for _ in range(10):
        op.tick()
        clock.advance(4.0)
    for _ in range(8):  # settle: rebind pods evicted by the last action
        if not op.state.pending_pods():
            break
        op.tick()
        clock.advance(2.0)
    cost2 = sum(ns.node.price for ns in op.state.nodes.values())
    print(f"  -> {len(op.state.nodes)} nodes, ${cost2:.2f}/hr, "
          f"pending={len(op.state.pending_pods())}, saved ${cost - cost2:.2f}/hr")
    if getattr(args, "tracez", False):
        # the observability surface, rendered for the terminal (make
        # obs-demo): per-span p50/p99 over the run + the recent trace trees
        from .obs.export import render_tracez, statusz

        print(render_tracez(op.flight))
        st = statusz(op.registry, op.flight)
        print("== /statusz ==")
        print(json.dumps(st, indent=2, default=str))
    op.shutdown()


def drain_warm_threads(rc: int = 0, grace_s: float = 60.0) -> None:
    """Bounded wait for background warm threads at process exit.

    Warm threads are deliberately non-daemon (solver/tpu.py), so normal
    exit JOINS them.  A warm hung on a wedged device (a call that never
    returns) would pin shutdown forever; give legitimate warm tails a
    bounded grace, then force the exit.  Call only from process entry
    points, after clean shutdown steps.
    """
    # ktlint: allow[KT002] process-exit join deadline: must track real
    # elapsed time even when the operator under test runs on a FakeClock —
    # a fake-advanced clock would zero the grace and strand live warms
    deadline = time.monotonic() + grace_s
    for t in threading.enumerate():
        if t.name == "tpu-solver-warm" and t is not threading.current_thread():
            t.join(max(0.0, deadline - time.monotonic()))  # ktlint: allow[KT002] see above
    stuck = sum(1 for t in threading.enumerate()
                if t.name == "tpu-solver-warm" and t.is_alive())
    if stuck:
        logging.getLogger(__name__).error(
            "%d background warm thread(s) still hung after %.0fs grace "
            "(wedged device?); forcing process exit", stuck, grace_s)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)  # preserve the command's exit code through the force


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="karpenter-tpu-torch")
    parser.add_argument("--demo", action="store_true", help="run the fake-cloud simulation")
    parser.add_argument("--pods", type=int, default=200)
    parser.add_argument("--small", action="store_true", help="20-type catalog")
    parser.add_argument("--backend", default="oracle", choices=["auto", "tpu", "oracle"])
    parser.add_argument("--metrics-port", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device of the in-process scheduler "
                             "(default the CUDA card, refusing to start "
                             "without one; 'cpu' runs the plain PyTorch "
                             "path on the host).  A remote operator "
                             "(--solver-address) needs no card")
    parser.add_argument("--solver-address",
                        default=os.environ.get("KARPENTER_SOLVER_ADDR", ""),
                        help="host:port of a solver sidecar (service.server); "
                             "empty solves in-process; defaults from "
                             "KARPENTER_SOLVER_ADDR (deploy/operator.yaml)")
    parser.add_argument("--config", default="",
                        help="YAML manifest file/dir (Provisioners, "
                             "NodeTemplates, settings) loaded through admission")
    parser.add_argument("--tracez", action="store_true",
                        help="print a /tracez + /statusz snapshot after the "
                             "demo (make obs-demo)")
    parser.add_argument("--warmup", action="store_true",
                        help="block on the bucket-grid warm before the "
                             "demo's first solve")
    args = parser.parse_args(argv)
    if args.demo:
        _demo(args)
        drain_warm_threads()
        return 0
    parser.print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
