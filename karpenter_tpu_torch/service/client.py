"""Solver service client — a BatchScheduler-compatible remote scheduler:
the port of the reference package's ``service/client.py``.

``RemoteScheduler`` is a drop-in for ``solver.scheduler.BatchScheduler`` so
controllers can point at a sidecar instead of solving in-process (the
reconciler <-> solver split of the north star; the reference consumes its
remote boundary the same way — ``cloudprovider.New(awsCtx)`` at
cmd/controller/main.go:44 is handed to every control loop).  The facade
contract (same methods, same signatures) is the reference's, pinned by
tests/test_torch_client.py.

The port's differences: the availability fallback is an oracle
``BatchScheduler`` on the host CPU (``device="cpu"``) — the operator runs
on a node without a card, and the fallback serves only while the sidecar
is unreachable or sheds a request under ``shed_fallback`` (counted in
``karpenter_solver_remote_fallback_solves_total`` and the
``karpenter_solver_remote_degraded`` gauge).  ``device`` names that host
device (the deprovisioning screen runs in the operator's process) and
``_tensorize_cache`` is None, so a consolidation sweep over the facade
sends each what-if as its own RPC.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Set

import grpc

from collections import OrderedDict

from .. import faults as faults_mod
from .. import gang as gangmod
from ..admission import SolveDeadlineError, SolveShedError, parse_class
from ..metrics import (
    FLEET_ENDPOINTS,
    FLEET_FAILOVER_REASONS,
    FLEET_FAILOVERS,
    Registry,
    registry as default_registry,
)
from ..utils.clock import Clock
from ..models.instancetype import InstanceType
from ..models.pod import PodSpec
from ..obs.trace import NULL_TRACE
from ..models.provisioner import Provisioner
from ..solver.scheduler import BatchScheduler
from ..solver.types import SimNode, SolveResult
from . import codec
from . import solver_pb2 as pb
from .delta import DeltaSessionUnknown, delta_enabled
from .server import SERVICE

logger = logging.getLogger(__name__)

from ..metrics import REMOTE_DEGRADED, REMOTE_FALLBACK_SOLVES  # noqa: E402
# (names + help text live in metrics.INVENTORY so docs/METRICS.md covers them)


class SolveRetriesExhausted(grpc.RpcError):
    """Transport UNAVAILABLE outlived the bounded retry budget — the
    replica is not merely restarting, it is gone.  Typed (callers
    back off / re-plan, never silent-retry), and still a
    ``grpc.RpcError`` with an UNAVAILABLE ``code()`` so availability-first
    facades (``RemoteScheduler``) keep their degrade-to-local-fallback
    behavior unchanged."""

    def __init__(self, msg: str, attempts: int) -> None:
        super().__init__(msg)
        self.attempts = attempts

    def code(self):
        return grpc.StatusCode.UNAVAILABLE

    def details(self) -> str:
        return str(self.args[0]) if self.args else ""


class SolveStepFailed(Exception):
    """A delta step failed server-side mid-apply (gRPC INTERNAL on a
    session call).  The server evicted the session (the half-mutated
    chain must never serve another epoch — service/server.py
    ``_serve_delta``); the client keeps its ledger + pending perturbation,
    and the NEXT ``solve_delta`` call re-establishes transparently via the
    session_unknown path — one full solve, never a diverged chain, never
    an untyped transport error through the facade."""


class SolverDraining(Exception):
    """The replica refused a session establishment because it is
    gracefully draining (``session_state="draining"``,
    docs/RESILIENCE.md).  A fleet-aware client never surfaces this — the
    :class:`FleetClient` re-routes the establishment to a sibling — but a
    single-endpoint ``DeltaSession`` pointed at a draining pod has
    nowhere to go: typed, the session ledger + pending perturbation
    survive, and the next call retries (against the replacement pod once
    it lands)."""


#: retry budget for transport UNAVAILABLE (KT_RPC_RETRIES): how many
#: RE-attempts one solve_raw pays before the typed give-up.  1 = ride
#: through a single replica restart; 0 disables ride-through.
DEFAULT_RPC_RETRIES = 1
#: base backoff before a retry, ms (KT_RPC_BACKOFF_MS); the actual sleep
#: is base * (1 + jitter) with jitter from the faults facade so a
#: restart storm's retries decorrelate
DEFAULT_RPC_BACKOFF_MS = 200.0


class SolverClient:
    def __init__(self, target: str, timeout: float = 60.0,
                 clock: Optional[Clock] = None,
                 retries: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 registry: Optional[Registry] = None) -> None:
        self.target = target
        self.timeout = timeout
        # injectable clock: tests drive the backoff without real sleeps
        self.clock = clock or Clock()
        if retries is None:
            retries = int(os.environ.get("KT_RPC_RETRIES",
                                         str(DEFAULT_RPC_RETRIES)))
        if backoff_s is None:
            backoff_s = float(os.environ.get(
                "KT_RPC_BACKOFF_MS", str(DEFAULT_RPC_BACKOFF_MS))) / 1000.0
        self.retries = max(0, retries)
        self.backoff_s = max(0.0, backoff_s)
        # transport fault site (docs/RESILIENCE.md): injected UNAVAILABLE/
        # reset errors exercise the retry path through real handling.
        # Recovery outcomes land in the registry the EMBEDDING hands us
        # (RemoteScheduler/DeltaSession pass theirs through), so the
        # site x outcome partition stays whole on custom registries.
        self._faults = faults_mod.plane()
        self._registry = registry or default_registry
        faults_mod.zero_init_recovery(self._registry)
        self._connect()

    def _connect(self) -> None:
        self.channel = grpc.insecure_channel(
            self.target,
            options=[("grpc.max_receive_message_length", 256 * 1024 * 1024),
                     ("grpc.max_send_message_length", 256 * 1024 * 1024)],
        )
        self._solve = self.channel.unary_unary(
            f"/{SERVICE}/Solve",
            request_serializer=pb.SolveRequest.SerializeToString,
            response_deserializer=pb.SolveResponse.FromString,
        )
        self._warm = self.channel.unary_unary(
            f"/{SERVICE}/Warm",
            request_serializer=pb.WarmRequest.SerializeToString,
            response_deserializer=pb.WarmResponse.FromString,
        )
        self._health = self.channel.unary_unary(
            f"/{SERVICE}/Health",
            request_serializer=pb.HealthRequest.SerializeToString,
            response_deserializer=pb.HealthResponse.FromString,
        )

    def reset(self) -> None:
        """Drop and rebuild the channel.  A grpc channel whose connection
        attempts started while the server was down can wedge in a
        reconnect-backoff state that outlives the outage (observed on this
        host as endless 'tcp handshaker shutdown' UNAVAILABLE errors against
        a LISTENING server); a fresh channel connects on its first try, so
        the degraded-path health probe resets after every failed attempt."""
        self.close()
        self._connect()

    def health(self, timeout: Optional[float] = None) -> pb.HealthResponse:
        return self._health(pb.HealthRequest(), timeout=timeout or self.timeout)

    def solve_raw(self, request: pb.SolveRequest,
                  timeout: Optional[float] = None) -> pb.SolveResponse:
        """One Solve RPC with restart ride-through:
        transport UNAVAILABLE — the exact shape of a replica restart —
        retries ONCE per budget unit (KT_RPC_RETRIES, default 1) after a
        jittered backoff on a fresh channel, then surfaces the typed
        :class:`SolveRetriesExhausted`.  Typed sheds are NEVER retried:
        RESOURCE_EXHAUSTED / DEADLINE_EXCEEDED mean the sidecar is
        protecting itself — overload is not an outage (the admission invariant), and a retry storm into an overloaded server is how
        outages are made."""
        # every path out of this loop returns or raises: the final
        # iteration's except always raises (attempt + 1 >= attempts
        # matches every error on the last pass)
        attempts = self.retries + 1
        for attempt in range(attempts):
            try:
                if self._faults:
                    self._faults.fire("transport")
                return self._solve(request, timeout=timeout or self.timeout)
            except grpc.RpcError as err:
                code = (err.code()
                        if callable(getattr(err, "code", None)) else None)
                if code != grpc.StatusCode.UNAVAILABLE \
                        or attempt + 1 >= attempts:
                    if code == grpc.StatusCode.UNAVAILABLE:
                        faults_mod.count_recovery(
                            self._registry, "transport", "failed")
                        raise SolveRetriesExhausted(
                            f"solver {self.target} unavailable after "
                            f"{attempts} attempt(s): "
                            f"{getattr(err, 'details', lambda: '')() or err}",
                            attempts) from err
                    raise
                # replica restarting: fresh channel (a channel that began
                # connecting mid-outage can wedge in backoff — see reset),
                # jittered pause, one more try.  Counted whether the
                # UNAVAILABLE was injected or organic.
                faults_mod.count_recovery(
                    self._registry, "transport", "retried")
                logger.debug(
                    "solver %s UNAVAILABLE (attempt %d/%d); retrying "
                    "after backoff", self.target, attempt + 1, attempts)
                self.reset()
                if self.backoff_s > 0:
                    self.clock.sleep(
                        self.backoff_s * (1.0 + faults_mod.jitter()))

    def warm_raw(self, request: pb.WarmRequest) -> pb.WarmResponse:
        return self._warm(request, timeout=self.timeout)

    def close(self) -> None:
        self.channel.close()


class FleetClient:
    """Endpoint-set transport over N solver replicas — session-affinity
    routing with warm failover (docs/RESILIENCE.md).

    Duck-types the slice of :class:`SolverClient` the session facades use
    (``solve_raw`` / ``timeout`` / ``reset`` / ``close``), so
    ``DeltaSession(..., client=FleetClient(...))`` is the whole wiring.
    Routing reads the REQUEST: ``session_id`` rendezvous-hashes over the
    live endpoints (highest-random-weight, so one replica death re-homes
    ONLY that replica's sessions and every client agrees on the target
    without coordination); sessionless solves ride the same hash of "".

    Failure handling, per RPC:

    - transport ``UNAVAILABLE`` surviving the per-endpoint retry budget
      -> the endpoint is marked DEAD (counted failover ``death``), the
      request re-routes to the next endpoint in rendezvous order and is
      re-sent.  For a delta step that is safe: the dead replica either
      never applied it, or applied it without replying — in which case
      the adopting replica's spool record is one epoch ahead, the epoch
      check answers ``session_unknown``, and the client pays the
      exactly-one re-establish instead of ever diverging.  With the
      shared spool current, the adopting replica serves the step WARM.
    - ``session_state="draining"`` on an ESTABLISHMENT -> the endpoint is
      marked DRAINING (counted failover ``drain``), the establishment
      re-sends to a sibling.  On a DELTA reply the served result is
      returned as-is and the endpoint marked, so the session's next RPC
      proactively re-homes before the pod dies.
    - typed sheds / deadline / INTERNAL pass through untouched — overload
      and step failures are per-replica postures, not routing events.

    Dead endpoints are re-probed (Health, ``PROBE_TIMEOUT``) at most once
    per ``reconnect_interval`` when routing wants them; a probe that
    answers revives the endpoint (a replaced pod on the same address).
    Draining endpoints revive the same way once their replacement serves.

    CLASSIC (session-less) solves route by BUCKET AFFINITY: the request's
    shape-signature proxy — pod-count rung, catalog rung, provisioner
    count — rendezvous-hashes over the fleet, so repeat shapes land on the
    replica whose tensorize cache already warmed them, instead of every
    sessionless solve hashing ``""`` onto one replica.  When the affinity
    home is dead/draining the request falls back to the LEAST-LOADED
    healthy endpoint (fewest in-flight RPCs through this client) rather
    than piling onto the next rendezvous winner.
    ``KT_FLEET_BUCKET_AFFINITY=0`` restores the legacy hash-of-"" route.

    Knobs: ``KT_FLEET_ENDPOINTS`` (comma-separated targets) when no
    explicit endpoint list is given.  Endpoint states are exported as
    ``karpenter_fleet_endpoints{state}`` and re-homes as
    ``karpenter_fleet_failovers_total{reason}``.
    """

    RECONNECT_INTERVAL = 5.0
    PROBE_TIMEOUT = 2.0

    def __init__(self, endpoints: Optional[Sequence[str]] = None,
                 timeout: float = 60.0,
                 retries: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 registry: Optional[Registry] = None,
                 clock: Optional[Clock] = None,
                 reconnect_interval: float = RECONNECT_INTERVAL) -> None:
        if endpoints is None:
            env = os.environ.get("KT_FLEET_ENDPOINTS", "")
            endpoints = [e.strip() for e in env.split(",") if e.strip()]
        if not endpoints:
            raise ValueError(
                "FleetClient needs at least one endpoint (pass endpoints= "
                "or set KT_FLEET_ENDPOINTS)")
        self.endpoints = list(endpoints)
        self.timeout = timeout
        self.clock = clock or Clock()
        self._registry = registry or default_registry
        self.reconnect_interval = reconnect_interval
        self._clients: Dict[str, SolverClient] = {
            ep: SolverClient(ep, timeout=timeout, clock=self.clock,
                             retries=retries, backoff_s=backoff_s,
                             registry=self._registry)
            for ep in self.endpoints
        }
        #: endpoint -> "healthy" | "dead" | "draining"
        self._state: Dict[str, str] = {ep: "healthy"
                                       for ep in self.endpoints}
        self._last_probe: Dict[str, float] = {ep: 0.0
                                              for ep in self.endpoints}
        #: classic-solve bucket affinity (KT_FLEET_BUCKET_AFFINITY)
        self._bucket_affinity = (
            os.environ.get("KT_FLEET_BUCKET_AFFINITY", "1") != "0")
        #: endpoint -> RPCs in flight through THIS client (the
        #: least-loaded fallback's signal); guarded-by: _load_lock
        self._inflight: Dict[str, int] = {ep: 0 for ep in self.endpoints}
        self._load_lock = threading.Lock()
        faults_mod.zero_init_recovery(self._registry)
        fo = self._registry.counter(FLEET_FAILOVERS)
        for reason in FLEET_FAILOVER_REASONS:
            if not fo.has({"reason": reason}):
                fo.inc({"reason": reason}, value=0.0)
        self._export_states()

    # ---- endpoint state --------------------------------------------------
    def _export_states(self) -> None:
        gauge = self._registry.gauge(FLEET_ENDPOINTS)
        states = list(self._state.values())
        gauge.set(float(len(states)), {"state": "known"})
        gauge.set(float(states.count("healthy")), {"state": "healthy"})
        gauge.set(float(states.count("draining")), {"state": "draining"})

    def _mark(self, endpoint: str, state: str) -> bool:
        """Transition an endpoint's state; True iff it actually changed
        (failover counting keys on the TRANSITION — a whole-fleet drain
        serving deltas through the last-resort path must not re-count
        every reply)."""
        if self._state.get(endpoint) == state:
            return False
        logger.warning("fleet endpoint %s -> %s", endpoint, state)
        self._state[endpoint] = state
        if state in ("dead", "draining"):
            # arm the revival probe a FULL interval out: an immediate
            # probe would flip a still-answering drainer straight back to
            # healthy and ping-pong the very sessions the hint re-homed
            # ktlint: allow[KT002] transport-health stopwatch, see
            # _revive_due
            self._last_probe[endpoint] = time.monotonic()
        self._export_states()
        return True

    def states(self) -> Dict[str, str]:
        """Endpoint -> state snapshot (observability/tests)."""
        return dict(self._state)

    def _revive_due(self, endpoint: str) -> bool:
        # ktlint: allow[KT002] transport-health stopwatch, the
        # RemoteScheduler._remote_ok precedent: probe pacing must follow
        # real wall progress, not an injected test clock
        now = time.monotonic()
        if now - self._last_probe.get(endpoint, 0.0) \
                < self.reconnect_interval:
            return False
        self._last_probe[endpoint] = now
        return True

    def _probe(self, endpoint: str) -> bool:
        client = self._clients[endpoint]
        try:
            ok = bool(client.health(timeout=self.PROBE_TIMEOUT).ok)
        except grpc.RpcError:
            # arm the NEXT probe with a fresh channel (the wedged-channel
            # class SolverClient.reset documents); a DRAINING pod that
            # stopped answering has died — dead-state probing now owns
            # its revival once the replacement serves
            client.reset()
            self._mark(endpoint, "dead")
            return False
        if ok:
            self._mark(endpoint, "healthy")
        return ok

    # ---- routing ---------------------------------------------------------
    @staticmethod
    def _weight(session_id: str, endpoint: str) -> int:
        import hashlib

        return int.from_bytes(
            hashlib.sha256(f"{session_id}|{endpoint}".encode()).digest()[:8],
            "big")

    def rendezvous(self, session_id: str) -> List[str]:
        """Every endpoint, best first (highest-random-weight hash of
        (session, endpoint)): the session's home is the first LIVE entry,
        and failover walks the same order on every client."""
        return sorted(self.endpoints,
                      key=lambda ep: self._weight(session_id, ep),
                      reverse=True)

    def endpoint_for(self, session_id: str,
                     exclude: Optional[set] = None) -> Optional[str]:
        """The session's current home: the first HEALTHY endpoint in
        rendezvous order.  Draining endpoints are routed around — the
        hint already handed the chain to the spool, so the next RPC must
        land on the sibling that will adopt it, not ping-pong back into
        the drainer — and serve only as a last resort when the whole
        fleet drains at once (they still answer deltas correctly; an
        establishment there is refused and retried).  Dead endpoints get
        a paced revival probe on the way.  None when everything is
        excluded or dead."""
        exclude = exclude or set()
        fallback = None
        for ep in self.rendezvous(session_id):
            if ep in exclude:
                continue
            state = self._state[ep]
            if state in ("dead", "draining") and self._revive_due(ep):
                # paced revival probe.  Dead: the replacement pod on the
                # same address answers -> healthy.  Draining: the pod
                # either still drains (probe ok -> healthy; one RPC will
                # re-mark it the moment it answers another hint — a
                # bounded mislabel, never a wrong result) or has died
                # (probe fails -> dead, and the dead path picks up its
                # replacement).  Without this, a drained-and-replaced
                # endpoint would stay excluded forever.
                self._probe(ep)
                state = self._state[ep]
            if state == "healthy":
                return ep
            if state == "draining" and fallback is None:
                fallback = ep  # an all-draining fleet still serves deltas
        return fallback

    @staticmethod
    def bucket_affinity_key(request) -> str:
        """Compile-signature PROXY of a classic solve request, computed
        client-side: pod-count rung (power of two — the shape-bucketing
        direction the server's solve_dims rungs quantize), instance-type
        rung, provisioner count, and whether new nodes are allowed.  Two
        requests with the same proxy very likely share server-side
        compile buckets and tensorize-cache shapes, so routing repeat
        shapes to one replica rides its warm programs; a proxy collision
        merely shares a replica, never a wrong result."""
        n_pods = len(getattr(request, "pods", ()) or ())
        n_types = len(getattr(request, "instance_types", ()) or ())
        n_provs = len(getattr(request, "provisioners", ()) or ())
        g = 1 << (n_pods - 1).bit_length() if n_pods > 0 else 0
        c = 1 << (n_types - 1).bit_length() if n_types > 0 else 0
        allow = getattr(request, "allow_new_nodes", True)
        return f"bucket:g{g}:c{c}:p{n_provs}:a{int(bool(allow))}"

    def _least_loaded(self, exclude: set) -> Optional[str]:
        """The healthy endpoint with the fewest in-flight RPCs through
        this client (ties broken by endpoint order) — the classic-solve
        fallback when the affinity home is down: spreading by load beats
        piling every orphaned bucket onto the next rendezvous winner."""
        with self._load_lock:
            loads = dict(self._inflight)
        best = None
        for ep in self.endpoints:
            if ep in exclude or self._state.get(ep) != "healthy":
                continue
            if best is None or loads.get(ep, 0) < loads.get(best, 0):
                best = ep
        return best

    def _classic_endpoint(self, key: str,
                          exclude: set) -> Optional[str]:
        """Routing for session-LESS solves: the bucket-affinity home
        (rendezvous winner for the request's compile-signature proxy)
        when it is healthy, else the least-loaded healthy endpoint
        (affinity miss), else the standard walk (drain fallbacks +
        revival probes)."""
        order = self.rendezvous(key)
        home = next((ep for ep in order if ep not in exclude), None)
        if home is not None:
            state = self._state[home]
            if state in ("dead", "draining") and self._revive_due(home):
                self._probe(home)
                state = self._state[home]
            if state == "healthy":
                return home
        fallback = self._least_loaded(exclude)
        if fallback is not None:
            return fallback
        return self.endpoint_for(key, exclude=exclude)

    # ---- SolverClient surface -------------------------------------------
    def solve_raw(self, request: pb.SolveRequest,
                  timeout: Optional[float] = None) -> pb.SolveResponse:
        sid = getattr(request, "session_id", "")
        establish = bool(sid) and not bool(getattr(request, "delta", False))
        classic_key = None
        if not sid and self._bucket_affinity:
            classic_key = self.bucket_affinity_key(request)
        tried: set = set()
        while True:
            if classic_key is not None:
                ep = self._classic_endpoint(classic_key, tried)
            else:
                ep = self.endpoint_for(sid, exclude=tried)
            if ep is None:
                raise SolveRetriesExhausted(
                    f"no live solver endpoint (of {len(self.endpoints)}) "
                    f"for session {sid or '<none>'}", len(tried))
            try:
                with self._load_lock:
                    self._inflight[ep] = self._inflight.get(ep, 0) + 1
                try:
                    resp = self._clients[ep].solve_raw(request,
                                                       timeout=timeout)
                finally:
                    with self._load_lock:
                        self._inflight[ep] = max(
                            0, self._inflight.get(ep, 0) - 1)
            except grpc.RpcError as err:
                code = (err.code()
                        if callable(getattr(err, "code", None)) else None)
                if code == grpc.StatusCode.UNAVAILABLE:
                    # the replica is gone (the per-endpoint retry budget
                    # already rode through a mere restart): fail the
                    # session over — the next endpoint adopts its chain
                    # from the shared spool and serves WARM.  Counted on
                    # the state TRANSITION, not per failing RPC.
                    if self._mark(ep, "dead"):
                        self._registry.counter(FLEET_FAILOVERS).inc(
                            {"reason": "death"})
                    faults_mod.count_recovery(
                        self._registry, "transport", "fallback")
                    tried.add(ep)
                    continue
                raise  # sheds / deadline / INTERNAL: per-replica posture
            if getattr(resp, "session_state", "") == "draining":
                if self._mark(ep, "draining"):
                    self._registry.counter(FLEET_FAILOVERS).inc(
                        {"reason": "drain"})
                if establish:
                    # the handshake's refusal half: nothing was served —
                    # re-home the establishment to a sibling.  When the
                    # WHOLE fleet is draining at once (rolling restart
                    # tail) there is no sibling: return the refusal so
                    # the session facade raises the typed, retriable
                    # SolverDraining — the replicas are alive and
                    # protecting their handoffs, which is not an outage
                    if self.endpoint_for(sid,
                                         exclude=tried | {ep}) is None:
                        return resp
                    tried.add(ep)
                    continue
                # a served delta carrying the hint: return it; the next
                # RPC for this session routes to a live sibling, which
                # adopts the handed-off chain warm
            return resp

    def reset(self) -> None:
        for client in self._clients.values():
            client.reset()

    def health(self, timeout: Optional[float] = None):
        """Health of the session-less routing target (facade parity)."""
        ep = self.endpoint_for("") or self.endpoints[0]
        return self._clients[ep].health(timeout=timeout)

    def close(self) -> None:
        for client in self._clients.values():
            client.close()


class RemoteScheduler:
    """BatchScheduler-compatible facade over the sidecar.

    Availability semantics: when the sidecar is unreachable, ``solve`` falls
    back to a LOCAL solve (oracle backend by default) so the control plane
    keeps reconciling — scale-up must not stall on a solver rollout.  After a
    failure the remote path is considered degraded; it is retried only
    through a cheap Health probe at most once per ``reconnect_interval``
    seconds (health-gated reconnect), so a down sidecar costs one probe per
    interval, not one deadline-wait per solve.
    """

    #: seconds between Health probes while degraded
    RECONNECT_INTERVAL = 5.0
    #: deadline for the Health probe itself — must be snappy: it sits on the
    #: reconcile path while degraded
    PROBE_TIMEOUT = 2.0

    def __init__(
        self,
        target: str,
        backend: str = "",
        timeout: float = 60.0,
        *,
        fallback: Optional[BatchScheduler] = None,
        reconnect_interval: float = RECONNECT_INTERVAL,
        registry: Optional[Registry] = None,
        priority: str = "",
        deadline_s: Optional[float] = None,
        shed_fallback: bool = False,
    ) -> None:
        self.client = SolverClient(target, timeout=timeout,
                                   registry=registry)
        self.target = target
        self.backend = backend
        # admission identity (docs/ADMISSION.md): every Solve this facade
        # sends carries the caller's priority class and deadline budget.
        # Constructor-level (not per-call) so the BatchScheduler facade
        # contract (tests/test_service.py::TestFacadeContract) stays
        # byte-for-byte — a control loop IS one priority class.
        self.priority = parse_class(priority) if priority else ""
        self.deadline_s = deadline_s
        # shed posture: library callers get the typed SolveShedError /
        # SolveDeadlineError (back off, re-plan); an availability-first
        # control loop (the operator's reconciler — it has no backoff
        # story, a raised shed would kill the whole loop) sets
        # shed_fallback=True: the shed is logged + counted and THIS solve
        # is served locally, WITHOUT latching the degraded path — the
        # sidecar is healthy and protecting itself, so the next solve
        # goes remote again.
        self.shed_fallback = shed_fallback
        self.mesh = None  # the device mesh lives sidecar-side
        self.registry = registry or default_registry
        # the operator's node has no card: the fallback runs on the host
        self.fallback = fallback or BatchScheduler(
            backend="oracle", registry=self.registry, device="cpu"
        )
        #: where work the caller runs in its own process lands (the
        #: deprovisioning screen): the fallback's host device
        self.device = self.fallback.device
        #: no host tensorize cache: a consolidation sweep over this facade
        #: solves each what-if through ``solve`` (one RPC each)
        self._tensorize_cache = None
        self.reconnect_interval = reconnect_interval
        self._degraded_since: Optional[float] = None
        self._last_probe = 0.0
        # zero-init so the series exists from the first scrape (inc(0)
        # creates the sample; construction alone does not)
        self.registry.counter(REMOTE_FALLBACK_SOLVES).inc(value=0.0)
        self.registry.gauge(REMOTE_DEGRADED).set(0)
        faults_mod.zero_init_recovery(self.registry)

    #: RPC status codes that mean "the sidecar is not reachable right now".
    #: Anything else (UNIMPLEMENTED from an older sidecar's missing Warm
    #: handler, INTERNAL on one bad request, ...) must NOT poison the Solve
    #: path: that call falls back / returns 0, the next one goes remote.
    TRANSPORT_CODES = (grpc.StatusCode.UNAVAILABLE,
                       grpc.StatusCode.DEADLINE_EXCEEDED)

    # ---- degradation state ------------------------------------------------
    def degraded(self) -> bool:
        return self._degraded_since is not None

    def _transport_failure(self, err: grpc.RpcError) -> bool:
        code = err.code() if callable(getattr(err, "code", None)) else None
        return code in self.TRANSPORT_CODES

    def _mark_degraded(self, err: Exception) -> None:
        if self._degraded_since is None:
            logger.warning("solver sidecar %s unreachable (%s); "
                           "falling back to local %s solves", self.target,
                           getattr(err, "code", lambda: err)(),
                           self.fallback.backend)
        # ktlint: allow[KT002] transport-health stopwatch: reconnect pacing
        # must follow real wall progress, not the operator's injected clock
        # (a FakeClock-driven test advancing hours would hot-loop probes)
        self._degraded_since = time.monotonic()
        self._last_probe = self._degraded_since
        self.registry.gauge(REMOTE_DEGRADED).set(1)

    def _remote_ok(self) -> bool:
        """True when the remote path should be attempted: healthy, or
        degraded but due for a (successful) health probe."""
        if self._degraded_since is None:
            return True
        now = time.monotonic()  # ktlint: allow[KT002] see _mark_degraded
        if now - self._last_probe < self.reconnect_interval:
            return False
        self._last_probe = now
        try:
            ok = bool(self.client.health(timeout=self.PROBE_TIMEOUT).ok)
        except grpc.RpcError:
            # arm the NEXT probe with a fresh channel: a channel that began
            # connecting while the sidecar was down can stay wedged after it
            # comes back (see SolverClient.reset) — without this the remote
            # path would never recover on affected stacks
            self.client.reset()
            return False
        if ok:
            logger.info("solver sidecar %s back after %.1fs; resuming remote "
                        "solves", self.target,
                        now - (self._degraded_since or now))
            self._degraded_since = None
            self.registry.gauge(REMOTE_DEGRADED).set(0)
        return ok

    # ---- BatchScheduler surface -------------------------------------------
    def solve(
        self,
        pods: Sequence[PodSpec],
        provisioners: Sequence[Provisioner],
        instance_types: Sequence[InstanceType],
        *,
        existing_nodes: Sequence[SimNode] = (),
        daemonsets: Sequence[PodSpec] = (),
        unavailable: Optional[Set[tuple]] = None,
        allow_new_nodes: bool = True,
        max_new_nodes: Optional[int] = None,
        trace=None,
        relax: Optional[bool] = None,
    ) -> SolveResult:
        # ``relax`` mirrors BatchScheduler.solve for facade parity; the
        # rung is a server-side refinement governed by the sidecar's own
        # KT_RELAX policy (the wire carries no per-request override), so
        # only the local-fallback solve below honors the caller's value
        #
        # gang audit client-side: a malformed gang would only
        # bounce off the server's INVALID_ARGUMENT — raise the same typed
        # error here, before paying the round trip (and identically on the
        # degraded local path, which skips the server's door check)
        gangmod.validate_batch(pods)
        trace = trace or NULL_TRACE
        if self._remote_ok():
            # fleet-wide tracing: the "remote" span's wire
            # context crosses with the request, so the sidecar's trace
            # opens as a CHILD of this span (same trace id, remote parent
            # linked) instead of an unrelated tree — /fleetz renders the
            # operator hop and the sidecar hop as one request
            with trace.span("remote", target=self.target) as span:
                wire_tid, wire_parent = trace.wire_context()
                req = codec.encode_request(
                    pods, provisioners, instance_types,
                    existing_nodes=existing_nodes, daemonsets=daemonsets,
                    unavailable=unavailable, allow_new_nodes=allow_new_nodes,
                    max_new_nodes=max_new_nodes, backend=self.backend,
                    priority=self.priority,
                    deadline_ms=(self.deadline_s * 1000.0
                                 if self.deadline_s else None),
                    trace_id=wire_tid, parent_span=wire_parent,
                )
                # the wire deadline budget also bounds the RPC itself: a
                # caller with 250ms left must not block 60s on the channel
                rpc_timeout = (min(self.client.timeout, self.deadline_s)
                               if self.deadline_s else None)
                try:
                    resp = self.client.solve_raw(req, timeout=rpc_timeout)
                except grpc.RpcError as err:
                    code = (err.code()
                            if callable(getattr(err, "code", None)) else None)
                    span.annotate(transport_error=str(code or err))
                    if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
                        # the sidecar SHED this request (admission queue
                        # full / rate limit / brownout).  Overload is not
                        # an outage — NEVER latch the degraded path (the
                        # sidecar is healthy, it is protecting itself).
                        # Library callers get the typed error so they back
                        # off; an availability-first reconcile loop
                        # (shed_fallback=True) logs it and serves THIS
                        # solve locally, next one goes remote again.
                        detail = getattr(err, "details", lambda: "")() or ""
                        if not self.shed_fallback:
                            # ktlint: allow[KT009] client-side re-map of a
                            # shed the serving side already counted in
                            # karpenter_admission_shed_total
                            raise SolveShedError(
                                f"solver sidecar shed this solve: {detail}",
                                pclass=self.priority, reason="remote_shed",
                            ) from err
                        logger.warning(
                            "solver sidecar shed this solve (%s); serving "
                            "it from the local fallback", detail)
                    elif (code == grpc.StatusCode.DEADLINE_EXCEEDED
                            and self.deadline_s is not None):
                        # the caller CONFIGURED a deadline budget and it is
                        # spent — whether in the sidecar's queue (its
                        # DEADLINE_EXCEEDED shed) or on the wire (the
                        # rpc_timeout above).  Latching degraded would hide
                        # sustained overload as an outage; a local solve
                        # blows the budget, so typed error by default —
                        # the reconcile loop (shed_fallback=True) prefers
                        # a late local answer over no answer.
                        # Without a configured budget, DEADLINE_EXCEEDED
                        # keeps its pre-admission meaning (the 60s channel
                        # timeout = sidecar unreachable -> degrade).
                        detail = getattr(err, "details", lambda: "")() or ""
                        if not self.shed_fallback:
                            # ktlint: allow[KT009] client-side re-map of a
                            # deadline the serving side already counted
                            raise SolveDeadlineError(
                                f"solve deadline budget "
                                f"({self.deadline_s:g}s) spent: {detail}",
                                pclass=self.priority, reason="deadline",
                            ) from err
                        logger.warning(
                            "solve deadline budget (%gs) spent (%s); "
                            "serving this solve from the local fallback",
                            self.deadline_s, detail)
                    elif self._transport_failure(err):
                        self._mark_degraded(err)
                    else:
                        logger.warning("remote solve failed (%s); serving this "
                                       "solve from the local fallback",
                                       err.code(), exc_info=True)
                else:
                    # which replica actually served (after any fleet
                    # failover re-route): stamped on the span so the
                    # client-side tree names the serving hop
                    served_by = getattr(resp, "replica_id", "") or ""
                    if served_by:
                        span.annotate(replica=served_by)
                    result = codec.decode_response(resp)
                    # re-attach real PodSpecs to returned nodes (wire carries
                    # names only)
                    by_name = {p.name: p for p in pods}
                    for node in result.nodes:
                        node.pods = [by_name.get(p.name, p) for p in node.pods]
                    return result
        self.registry.counter(REMOTE_FALLBACK_SOLVES).inc()
        # recovery-outcome funnel (KT016): every local-fallback serve IS a
        # recovery from a transport-path failure, injected or organic
        faults_mod.count_recovery(self.registry, "transport", "fallback")
        trace.annotate(remote_fallback=True)
        return self.fallback.solve(
            pods, provisioners, instance_types,
            existing_nodes=existing_nodes, daemonsets=daemonsets,
            unavailable=unavailable, allow_new_nodes=allow_new_nodes,
            max_new_nodes=max_new_nodes, trace=trace, relax=relax,
        )

    def warm_startup(
        self,
        provisioners,
        instance_types,
        daemonsets: Sequence[PodSpec] = (),
        existing_nodes: Sequence[SimNode] = (),
        profiles=None,
    ) -> int:
        """Forward the live cluster shape to the sidecar so IT warms the
        ladder (warms belong next to the card).  Best-effort like the
        local warmup: an unreachable sidecar degrades the remote path and
        returns 0 — solves still work via the fallback.  ``profiles`` stays
        sidecar-side (the wire carries the cluster, not the rungs)."""
        if not self._remote_ok():
            return 0
        req = codec.encode_warm_request(
            provisioners, instance_types, daemonsets=daemonsets,
            existing_nodes=existing_nodes, backend=self.backend,
        )
        try:
            return int(self.client.warm_raw(req).started)
        except grpc.RpcError as err:
            if self._transport_failure(err):
                self._mark_degraded(err)
            else:
                # e.g. UNIMPLEMENTED from a pre-Warm sidecar during a rolling
                # upgrade: warmup is best-effort, Solve still works — do not
                # degrade the solve path over it
                logger.debug("remote warm_startup failed (%s); skipping",
                             err.code())
            return 0

    def stop_warms(self) -> None:
        """Operator shutdown: stop the LOCAL fallback's background warms.
        The sidecar owns its own warm lifecycle (it stops warms when its
        process stops), so nothing is sent remotely."""
        self.fallback.stop_warms()

    def close(self) -> None:
        self.client.close()


class DeltaSession:
    """Session-stateful delta client over the Solve RPC — warm start over
    the wire (docs/ARCHITECTURE.md).

    ``solve()`` establishes the session with one classic full solve;
    ``solve_delta()`` then ships only the PERTURBATION (pod adds/removes,
    ICE'd offerings, node reclaims, catalog-epoch bumps) and merges the
    server's delta-shaped reply into a local ledger — steady-state churn
    costs O(delta) on the wire and sub-milliseconds on the server instead
    of re-shipping and re-solving the cluster.

    Divergence safety: the server acks an epoch per applied step, and the
    client sends its last ack as ``base_epoch``.  Any mismatch — evicted
    session, server restart, a response lost to a deadline — is answered
    ``session_state="unknown"``, and the client transparently re-sends the
    full cluster AT MOST ONCE per call (no retry loop against a flapping
    server; the full solve re-establishes the session).  Unacked
    perturbations accumulate until a step is acked, so a shed/deadline'd
    delta is simply retried cumulatively on the next call — never lost,
    never double-applied.

    Shed posture (the typed surface): ``RESOURCE_EXHAUSTED`` maps to
    :class:`SolveShedError` and a budgeted ``DEADLINE_EXCEEDED`` to
    :class:`SolveDeadlineError` WITHOUT consuming the session — the
    sidecar is protecting itself, not forgetting the chain; back off and
    call again.  Transport ``UNAVAILABLE`` (a replica restarting under
    us) rides through ONE bounded jittered-backoff retry inside
    ``SolverClient.solve_raw`` (KT_RPC_RETRIES), then surfaces the typed
    :class:`SolveRetriesExhausted`; the session is KEPT either way — a
    snapshot-restoring replacement replica serves the next delta warm,
    and a replacement without our chain answers ``unknown`` for exactly
    one re-establishing full solve (docs/RESILIENCE.md).

    Fleet posture: pass ``client=FleetClient([...])`` and the
    session rides the whole replica fleet — rendezvous affinity routing,
    failover on replica death (the sibling ADOPTS the chain from the
    shared spool and serves the next delta warm), and proactive
    re-homing on the graceful-drain ``session_state="draining"`` hint,
    which this facade treats as a served step.

    ``KT_DELTA=0`` (client-side) turns the facade into a plain full-solve
    client: every call re-ships the cluster with NO session fields on the
    wire — byte-identical requests to pre-delta serving.

    Results are VIEWS: the returned :class:`SolveResult` shares the
    session's ledger containers (same ownership contract as
    ``solver/warmstart.delta_solve`` consuming ``prev``); snapshot before
    mutating.  Single-threaded by contract, like the scheduler facades.
    """

    def __init__(self, target: str, *, session_id: Optional[str] = None,
                 timeout: float = 60.0, backend: str = "",
                 priority: str = "", deadline_s: Optional[float] = None,
                 client: Optional[SolverClient] = None,
                 registry: Optional[Registry] = None) -> None:
        import uuid

        self.client = client or SolverClient(target, timeout=timeout,
                                             registry=registry)
        self.session_id = session_id or uuid.uuid4().hex
        self.backend = backend
        self.priority = parse_class(priority) if priority else ""
        self.deadline_s = deadline_s
        self.enabled = delta_enabled()
        # fleet-wide tracing: the session's JOURNEY trace id —
        # one stable, origin-prefixed id for the session's whole life, so
        # every hop it touches (establish on its home, deltas on a
        # steal-adopting sibling after a kill, drain handoffs) adopts the
        # same id server-side and /fleetz renders the journey as ONE
        # timeline.  The SAMPLING decision is made HERE, at the origin,
        # at session granularity: the server-side facade deliberately
        # bypasses sampling for adopted contexts (a half-sampled tree is
        # worse than none), so an unconditional journey id would defeat
        # KT_TRACE_SAMPLE_EVERY on the sub-ms delta hot path entirely.
        # 1-in-N SESSIONS trace their whole journey, decided
        # deterministically from the session id so a client restart (or
        # a second client of the same session) keeps the same decision.
        # KT_TRACE=0 client-side sends no context at all.
        self._trace_id = ""
        if os.environ.get("KT_TRACE", "1") != "0":
            import hashlib

            from ..obs.trace import replica_id as _origin_id

            every = max(1, int(os.environ.get("KT_TRACE_SAMPLE_EVERY",
                                              "1")))
            digest = int.from_bytes(
                hashlib.sha256(self.session_id.encode()).digest()[:8],
                "big")
            if digest % every == 0:
                self._trace_id = (
                    f"{_origin_id()}-sess-{self.session_id[:12]}")
        #: which replica served the last RPC (SolveResponse.replica_id) —
        #: "" against pre-tracing servers
        self.last_replica = ""
        # --- cluster ledger (ground truth the caller has asserted) ---
        self._pods: Optional[Dict[str, PodSpec]] = None  # None: no solve yet
        self._provisioners: List[Provisioner] = []
        self._instance_types: List[InstanceType] = []
        self._existing: List[SimNode] = []
        #: pod name -> existing-node NAME for pods pre-seated on shipped
        #: existing nodes (never in _pods/_assignments): removals of those
        #: pods must unseat them from the _existing ledger too, or a later
        #: re-establish ships phantom pods as seated ground truth
        self._preseated: Dict[str, str] = {}
        self._existing_by_name: Dict[str, SimNode] = {}
        self._daemonsets: List[PodSpec] = []
        self._unavailable: set = set()
        self._allow_new_nodes = True
        self._max_new_nodes: Optional[int] = None
        self._it_by_name: Dict[str, InstanceType] = {}
        self._catalog_epoch = 0
        # --- solution ledger (merged from replies) ---
        self._assignments: Dict[str, str] = {}
        self._infeasible: Dict[str, str] = {}
        self._nodes: "OrderedDict[str, SimNode]" = OrderedDict()
        self._last_ms = 0.0
        # --- session wire state ---
        self._established = False
        self._epoch = 0
        # chain-identity nonce, minted by the server at establishment and
        # echoed on every delta: lets the server reject a delta whose
        # base_epoch collides with a DIFFERENT chain lineage (spool
        # rollback) instead of silently applying it.  "" until the first
        # establishment — and forever against a pre-nonce server, which
        # both sides treat as the legacy wildcard.
        self._nonce = ""
        # --- unacked perturbation (cumulative since the last ack; kept
        # across typed sheds so nothing is lost, cleared on ack) ---
        self._pend_add: Dict[str, PodSpec] = {}
        self._pend_rm: Dict[str, None] = {}
        self._pend_reclaim: List[str] = []
        self._pend_ice: set = set()
        self._catalog_dirty = False
        #: full-solve resends this session performed (tests pin the
        #: at-most-once-per-call contract on it)
        self.full_resends = 0
        #: delta RPCs attempted (ack'd or not)
        self.delta_rpcs = 0

    @property
    def established(self) -> bool:
        return self._established

    @property
    def epoch(self) -> int:
        return self._epoch

    # ---- public API -----------------------------------------------------
    def solve(
        self,
        pods: Sequence[PodSpec],
        provisioners: Sequence[Provisioner],
        instance_types: Sequence[InstanceType],
        *,
        existing_nodes: Sequence[SimNode] = (),
        daemonsets: Sequence[PodSpec] = (),
        unavailable: Optional[Set[tuple]] = None,
        allow_new_nodes: bool = True,
        max_new_nodes: Optional[int] = None,
        catalog_epoch: int = 0,
    ) -> SolveResult:
        """(Re-)establish the session: full solve, full cluster on the
        wire, ledger reset to the arguments."""
        # same fail-fast gang audit as the server door
        gangmod.validate_batch(pods)
        self._pods = {p.name: p for p in pods}
        self._provisioners = list(provisioners)
        self._instance_types = list(instance_types)
        self._it_by_name = {it.name: it for it in self._instance_types}
        self._existing = list(existing_nodes)
        self._existing_by_name = {n.name: n for n in self._existing}
        self._preseated = {p.name: n.name
                           for n in self._existing for p in n.pods}
        self._daemonsets = list(daemonsets)
        self._unavailable = set(unavailable or ())
        self._allow_new_nodes = allow_new_nodes
        self._max_new_nodes = max_new_nodes
        self._catalog_epoch = int(catalog_epoch)
        self._clear_pending()
        return self._reestablish()

    def solve_delta(
        self,
        added: Sequence[PodSpec] = (),
        removed: Sequence[str] = (),
        iced: Sequence[object] = (),
        *,
        catalog_epoch: Optional[int] = None,
        provisioners: Optional[Sequence[Provisioner]] = None,
        instance_types: Optional[Sequence[InstanceType]] = None,
    ) -> SolveResult:
        """One churn step: ``added`` pods join, ``removed`` pod names
        leave, ``iced`` entries are offering tuples newly unavailable or
        node NAMES reclaimed (their pods re-place).  A ``catalog_epoch``
        bump (price/catalog change) must ship the new ``instance_types``;
        the server then re-seeds the chain from the stripped base instead
        of cold-starting the session."""
        if self._pods is None:
            raise DeltaSessionUnknown(
                "DeltaSession.solve() must establish the session before "
                "solve_delta()")
        # an added gang is one perturbation — audit it before it enters
        # the ledger, same typed error as the server door
        gangmod.validate_batch(added)
        # 1. fold the perturbation into the cluster ledger + pending set.
        # Removals BEFORE adds, matching the server's apply order
        # (warmstart unseats removals first, then places adds), so a
        # same-call replace (removed=[X], added=[X']) keeps both halves.
        for name in removed:
            self._pods.pop(name, None)
            if name in self._pend_add:
                del self._pend_add[name]  # the server never saw the add
            else:
                self._pend_rm[name] = None
        for p in added:
            self._pods[p.name] = p
            self._pend_add[p.name] = p
            # a pending REMOVAL of the same name stays pending: the
            # server's old pod is still seated until the removal lands,
            # and dropping it here would double-book the old node with
            # a silently diverging chain (the server applies removed
            # before added, so sending both is exactly right)
        for entry in iced:
            if isinstance(entry, str):
                self._reclaim_locally(entry)
                self._pend_reclaim.append(entry)
            else:
                self._unavailable.add(tuple(entry))
                self._pend_ice.add(tuple(entry))
        if catalog_epoch is not None and catalog_epoch != self._catalog_epoch:
            if instance_types is None:
                raise ValueError(
                    "a catalog_epoch bump must carry the new instance_types")
            self._catalog_epoch = int(catalog_epoch)
            self._instance_types = list(instance_types)
            self._it_by_name = {it.name: it for it in self._instance_types}
            if provisioners is not None:
                self._provisioners = list(provisioners)
            self._catalog_dirty = True
        # 2. dispatch: delta when the session is live, else ONE full solve
        if not self.enabled or not self._established:
            return self._reestablish()
        req = codec.encode_request(
            list(self._pend_add.values()),
            self._provisioners if self._catalog_dirty else (),
            self._instance_types if self._catalog_dirty else (),
            unavailable=set(self._pend_ice),
            backend=self.backend, priority=self.priority,
            deadline_ms=(self.deadline_s * 1000.0
                         if self.deadline_s else None),
            session_id=self.session_id, base_epoch=self._epoch, delta=True,
            removed_pods=list(self._pend_rm),
            reclaimed_nodes=list(self._pend_reclaim),
            catalog_epoch=self._catalog_epoch,
            session_nonce=self._nonce,
            # "s1" = the establishment hop's root (root span ids are "s1"
            # by construction): every delta hop attaches under the
            # journey's establishing hop in the /fleetz tree — including
            # hops served by an ADOPTING sibling after failover, which is
            # what makes the whole journey ONE remote-parent-linked tree
            trace_id=self._trace_id, parent_span="s1" if self._trace_id
            else "",
        )
        self.delta_rpcs += 1
        reply = codec.decode_delta_reply(self._rpc(req))
        if reply.state not in ("ok", "draining"):
            # SESSION_UNKNOWN (evicted / epoch mismatch / delta-off
            # server): exactly ONE transparent full resend re-establishes
            # — never a retry loop, never a silently diverged chain
            self._established = False
            return self._reestablish()
        # "draining" is a SERVED step plus a hint (the graceful fleet
        # handshake): the replica applied this delta, spooled the chain
        # and released its lease — the session stays established, and a
        # fleet-aware transport routes the next RPC to a sibling, which
        # adopts the chain and serves it warm (docs/RESILIENCE.md)
        self._epoch = reply.epoch
        if reply.nonce:
            self._nonce = reply.nonce
        if reply.full:
            self._apply_full(reply)
        else:
            self._apply_delta(reply)
        self._clear_pending()
        self._last_ms = reply.solve_ms
        return self.result()

    def result(self) -> SolveResult:
        """The session's current solution VIEW (shared containers — valid
        until the next call; snapshot to keep)."""
        return SolveResult(
            nodes=list(self._nodes.values()),
            assignments=self._assignments,
            infeasible=self._infeasible,
            existing_nodes=list(self._existing),
            solve_ms=self._last_ms,
        )

    def close(self) -> None:
        self.client.close()

    # ---- internals ------------------------------------------------------
    def _clear_pending(self) -> None:
        self._pend_add.clear()
        self._pend_rm.clear()
        self._pend_reclaim = []
        self._pend_ice = set()
        self._catalog_dirty = False

    def _reclaim_locally(self, name: str) -> None:
        """A node reclaim mutates the cluster ledger NOW (the node is
        gone, that is ground truth); its displaced pods become offered
        pods so a later full re-establish still schedules them.  The
        SOLUTION ledger only changes when a reply is acked."""
        kept = []
        for n in self._existing:
            if n.name == name:
                for p in n.pods:
                    self._preseated.pop(p.name, None)
                    if not p.is_daemon:
                        self._pods[p.name] = p
            else:
                kept.append(n)
        self._existing = kept
        self._existing_by_name.pop(name, None)

    def _rpc(self, req: pb.SolveRequest) -> pb.SolveResponse:
        """solve_raw with the typed shed surface.  Typed sheds do NOT
        consume the session (pending perturbation + epoch survive for the
        next call); transport failures KEEP it too: a
        snapshot-restoring replacement replica serves the next delta
        warm, and one without our chain answers session_unknown for
        exactly one re-establishing full solve."""
        rpc_timeout = (min(self.client.timeout, self.deadline_s)
                       if self.deadline_s else None)
        try:
            resp = self.client.solve_raw(req, timeout=rpc_timeout)
            # the serving replica's identity (stamped server-side): after
            # a fleet failover this names the ADOPTING sibling — the
            # client-visible half of the session's journey timeline
            self.last_replica = getattr(resp, "replica_id", "") or ""
            return resp
        except grpc.RpcError as err:
            code = (err.code()
                    if callable(getattr(err, "code", None)) else None)
            detail = getattr(err, "details", lambda: "")() or ""
            if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
                # ktlint: allow[KT009] client-side re-map of a shed the
                # serving side already counted in karpenter_admission_shed_total
                raise SolveShedError(
                    f"solver sidecar shed this delta solve: {detail}",
                    pclass=self.priority, reason="remote_shed") from err
            if (code == grpc.StatusCode.DEADLINE_EXCEEDED
                    and self.deadline_s is not None):
                # ktlint: allow[KT009] client-side re-map of a deadline the
                # serving side already counted
                raise SolveDeadlineError(
                    f"solve deadline budget ({self.deadline_s:g}s) spent: "
                    f"{detail}", pclass=self.priority,
                    reason="deadline") from err
            if code == grpc.StatusCode.INTERNAL or code == getattr(
                    grpc.StatusCode, "UNKNOWN", None):
                # the server failed MID-STEP (it evicted our session; the
                # dispatcher re-raised into the RPC).  Typed surface: the
                # session ledger + pending perturbation survive, and the
                # next call re-establishes via session_unknown — exactly
                # one full solve (docs/RESILIENCE.md invariant: errors
                # are typed, recovery cost is bounded)
                faults_mod.count_recovery(
                    self.client._registry, "delta_step", "failed")
                raise SolveStepFailed(
                    f"delta step failed server-side: {detail}") from err
            # transport failure after the client's bounded ride-through
            # retry (SolverClient.solve_raw): rebuild the channel, KEEP
            # the session — the replacement replica restores the
            # KT_SESSION_DIR spool and serves our next delta WARM
            # (docs/RESILIENCE.md).  Keeping it is safe either way: if
            # the restart lost (or half-applied) our chain, the epoch
            # check answers session_unknown and the next call pays
            # exactly ONE re-establishing full solve — the pre-snapshot
            # behavior, never a diverged chain.
            self.client.reset()
            raise

    def _reestablish(self) -> SolveResult:
        """ONE full solve from the cluster ledger; establishes the session
        when both sides have delta serving on."""
        session_kw = {}
        if self.enabled:
            session_kw = dict(session_id=self.session_id, delta=False,
                              catalog_epoch=self._catalog_epoch)
        req = codec.encode_request(
            list(self._pods.values()), self._provisioners,
            self._instance_types,
            existing_nodes=self._existing, daemonsets=self._daemonsets,
            unavailable=self._unavailable or None,
            allow_new_nodes=self._allow_new_nodes,
            max_new_nodes=self._max_new_nodes,
            backend=self.backend, priority=self.priority,
            deadline_ms=(self.deadline_s * 1000.0
                         if self.deadline_s else None),
            trace_id=self._trace_id,
            **session_kw,
        )
        self.full_resends += 1
        reply = codec.decode_delta_reply(self._rpc(req))
        if self.enabled and reply.state == "draining":
            # an establishment REFUSED by a draining replica, and the
            # transport had no sibling to re-route to (single-endpoint
            # client, or the whole fleet draining at once).  Nothing was
            # solved; ledger + pending perturbation survive for a retry
            # against the replacement pod.
            raise SolverDraining(
                "solver is draining and refused the session "
                "establishment; retry shortly (a FleetClient re-homes "
                "this automatically)")
        self._established = reply.state == "ok"
        self._epoch = reply.epoch
        # the establishment reply carries the chain's fresh identity;
        # a pre-nonce server leaves it "" (wildcard) and nothing changes
        self._nonce = reply.nonce if self._established else ""
        self._apply_full(reply)
        self._clear_pending()
        self._last_ms = reply.solve_ms
        return self.result()

    def _attach(self, node: SimNode) -> SimNode:
        """Re-attach the ledger's real PodSpecs (the wire carries names)
        and re-hydrate node fidelity from the ledger's catalog: the wire's
        NewNode is placement-only (type/zone/ct/price/pod names), but
        callers — and the ground-truth validator — read allocatable and
        labels off the session's view."""
        node.pods = [self._pods.get(p.name, p) for p in node.pods]
        it = self._it_by_name.get(node.instance_type)
        if it is not None and not node.allocatable:
            node.allocatable = dict(it.allocatable)
        node.stamp_labels()
        return node

    def _apply_full(self, reply) -> None:
        self._assignments = dict(reply.assignments)
        self._infeasible = dict(reply.infeasible)
        self._nodes = OrderedDict(
            (n.name, self._attach(n)) for n in reply.nodes)

    def _apply_delta(self, reply) -> None:
        """Merge one acked incremental step into the solution ledger, in
        the same order the server applied it: removals unseat, reclaims
        and pruned proposals drop nodes, new nodes appear, then the
        step's (re)placements land."""
        # removals: targeted scan-and-delete of the ONE departing pod per
        # node (the merge runs on every delta RPC — a full pods-list
        # rebuild per removal would cost O(delta x node width))
        for name in self._pend_rm:
            old = self._assignments.pop(name, None)
            self._infeasible.pop(name, None)
            if old is None:
                # a pod PRE-SEATED on a shipped existing node (never in
                # assignments): unseat it from the _existing ledger too —
                # a re-establish ships those pods as seated ground truth,
                # and a phantom would make the server pack around
                # capacity the departed pod no longer uses
                old = self._preseated.pop(name, None)
                node = (self._existing_by_name.get(old)
                        if old is not None else None)
            else:
                node = self._nodes.get(old)
            if node is not None:
                for i, p in enumerate(node.pods):
                    if p.name == name:
                        del node.pods[i]
                        break
        for rname in self._pend_reclaim:
            node = self._nodes.pop(rname, None)
            for p in (node.pods if node is not None else ()):
                self._assignments.pop(p.name, None)
            # a reclaimed EXISTING node left the ledger at call time; any
            # OTHER placement that pointed at it (a delta-placed pod) is
            # superseded by this reply — every displaced pod arrives in
            # reply.assignments or reply.infeasible (the server's watch
            # set), so no O(cluster) sweep of the assignments dict is
            # needed here
        for rname in reply.removed_nodes:
            self._nodes.pop(rname, None)
        for node in reply.nodes:
            self._nodes[node.name] = self._attach(node)
        # the step's placements: every watch pod was UNSEATED before this
        # step placed it (adds were never seated, re-offers were
        # infeasible, reclaim-displaced pods lost their node above, and
        # the incremental tiers never move any other pod), and a node
        # arriving in reply.nodes already carries its pods — so appends
        # below need no membership scan
        new_names = {n.name for n in reply.nodes}
        for name, target in reply.assignments.items():
            old = self._assignments.get(name)
            if old is not None and old != target:
                onode = self._nodes.get(old)  # robustness: never expected
                if onode is not None:
                    onode.pods = [p for p in onode.pods if p.name != name]
            self._assignments[name] = target
            self._infeasible.pop(name, None)
            if target not in new_names:
                tnode = self._nodes.get(target)
                if tnode is not None:
                    tnode.pods.append(
                        self._pods.get(name, PodSpec(name=name)))
        for name, why in reply.infeasible.items():
            if name in self._pods:
                self._infeasible[name] = why
                # a pod that WAS placed and is now unplaceable (its node
                # reclaimed, nowhere to go) must not keep a stale entry
                self._assignments.pop(name, None)
