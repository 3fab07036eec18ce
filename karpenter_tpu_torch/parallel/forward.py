"""Cross-host megabatch result forwarding: the port of the reference
package's ``parallel/forward.py``.

A multi-process mesh serves one coalesced megabatch SPMD: every serving
process runs the same dispatch, but each reads back and extracts ONLY the
request slots its own mesh entries hold (solver/tpu.py
``PendingMegaSolve.results`` — the per-host fence).  A request whose RPC
arrived on process A but whose slot landed on process B therefore resolves
locally to the typed :class:`SlotNotOwned`, and the serving layer routes it
through this shim: the request is re-sent to the OWNING process's serving
endpoint over the port's ``service.client.SolverClient``, which answers it
from its own scheduler.

Knobs:

- ``KT_MULTIHOST_PEERS`` — comma-separated solver endpoints, list index ==
  the owning process's ``torch.distributed`` rank.  Unset = no peers = the
  shim reports disabled and foreign slots surface their typed error (the
  single-process default: foreign slots cannot exist there).
- ``KT_MULTIHOST_FORWARD`` — ``0`` disables forwarding even with peers
  configured (foreign slots fail typed).

Tests inject ``transport=`` (a callable ``(endpoint, kwargs) -> SolveResult``)
so the routing/demux contract is pinned without a live fleet.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Dict, List, Optional

from ..obs.trace import NULL_TRACE

logger = logging.getLogger(__name__)


class SlotNotOwned(RuntimeError):
    """A megabatch slot this process holds no addressable shard of: the
    per-host fence (solver/tpu.py ``PendingMegaSolve.results``) boxes this
    into the slot's position instead of paying DCN to read it back.
    ``owner`` is the owning ``torch.distributed`` rank (-1 when unknown)."""

    def __init__(self, slot: int, owner: int = -1) -> None:
        super().__init__(
            f"megabatch slot {slot} is owned by process {owner}; this "
            "process fenced only its addressable shards")
        self.slot = int(slot)
        self.owner = int(owner)


def _env_peers() -> List[str]:
    raw = os.environ.get("KT_MULTIHOST_PEERS", "")
    return [e.strip() for e in raw.split(",") if e.strip()]


class ResultForwarder:
    """Route a foreign-slot request to the owning host's serving endpoint.

    The default transport re-sends the solve over the port's
    ``SolverClient`` (one cached client per peer endpoint) and decodes the
    owner's response.  ``forward()`` raises the original
    :class:`SlotNotOwned` when the shim is disabled or the owner has no
    configured endpoint — callers treat that exactly like any other
    per-slot typed failure."""

    def __init__(self, peers: Optional[List[str]] = None, registry=None,
                 transport: Optional[Callable] = None,
                 enabled: Optional[bool] = None) -> None:
        self.peers = list(peers) if peers is not None else _env_peers()
        self.registry = registry
        self.transport = transport
        if enabled is None:
            enabled = (os.environ.get("KT_MULTIHOST_FORWARD", "1") != "0"
                       and (bool(self.peers) or transport is not None))
        self._enabled = bool(enabled)
        self._clients: Dict[str, object] = {}   # guarded-by: _lock
        self._lock = threading.Lock()

    def enabled(self) -> bool:
        return self._enabled

    def _count(self, outcome: str) -> None:
        if self.registry is None:
            return
        from ..metrics import MULTIHOST_FORWARDS

        self.registry.counter(MULTIHOST_FORWARDS).inc({"outcome": outcome})

    def zero_init(self) -> None:
        """Every forward-outcome series exists at 0 from construction of
        the owning pipeline."""
        if self.registry is None:
            return
        from ..metrics import MULTIHOST_FORWARD_OUTCOMES, MULTIHOST_FORWARDS

        c = self.registry.counter(MULTIHOST_FORWARDS)
        for outcome in MULTIHOST_FORWARD_OUTCOMES:
            c.inc({"outcome": outcome}, value=0.0)

    def endpoint_of(self, owner: int) -> Optional[str]:
        if 0 <= owner < len(self.peers):
            return self.peers[owner]
        return None

    def _client(self, endpoint: str):
        # lazy import: parallel/ must not pull the gRPC stack (or the
        # service package) in at mesh-construction time
        from ..service.client import SolverClient

        with self._lock:
            client = self._clients.get(endpoint)
            if client is None:
                client = SolverClient(endpoint, registry=self.registry)
                self._clients[endpoint] = client
            return client

    def forward(self, kwargs: dict, err: SlotNotOwned,
                priority: str = ""):
        """Serve one foreign-slot request from its owning host; returns
        the owner's ``SolveResult``.  ``priority`` carries the ORIGIN
        host's admitted class onto the wire so the owner re-admits the
        request in the same class (an already-admitted critical solve
        must not become default-class — and sheddable — just because its
        slot landed on another host; the original deadline budget is
        enforced origin-side by admission before dispatch, so the
        forwarded RPC rides the transport's own timeout).  Re-raises
        ``err`` when the shim is off or the owner is unroutable, and
        wraps transport failures so the caller's RPC thread sees a
        typed, attributable error."""
        if not self._enabled:
            self._count("unrouted")
            raise err
        endpoint = self.endpoint_of(err.owner)
        # fleet-wide tracing: the forwarded hop is a CHILD of
        # the originating flush's trace — the "forward" span crosses the
        # wire as the remote parent, so the owner host's trace attaches
        # under it and /fleetz renders the foreign slot inside the
        # request's own tree instead of as an orphan on another replica
        trace = kwargs.get("trace") or NULL_TRACE
        with trace.span("forward", slot=err.slot, owner=err.owner,
                        endpoint=endpoint or ""):
            if self.transport is not None:
                try:
                    out = self.transport(endpoint, kwargs)
                except Exception:
                    self._count("error")
                    raise
                self._count("forwarded")
                return out
            if endpoint is None:
                self._count("unrouted")
                raise err
            from ..service import codec

            wire_tid, wire_parent = trace.wire_context()
            req = codec.encode_request(
                kwargs["pods"], kwargs["provisioners"],
                kwargs["instance_types"],
                existing_nodes=kwargs.get("existing_nodes", ()),
                daemonsets=kwargs.get("daemonsets", ()),
                unavailable=kwargs.get("unavailable"),
                allow_new_nodes=kwargs.get("allow_new_nodes", True),
                max_new_nodes=kwargs.get("max_new_nodes"),
                priority=priority or "",
                trace_id=wire_tid, parent_span=wire_parent,
            )
            try:
                resp = self._client(endpoint).solve_raw(req)
            except Exception as exc:
                self._count("error")
                raise RuntimeError(
                    f"forwarding slot {err.slot} to owning host "
                    f"{err.owner} ({endpoint}) failed: {exc}") from exc
            self._count("forwarded")
            return codec.decode_response(resp)

    def close(self) -> None:
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            try:
                c.close()
            except Exception:  # ktlint: allow[KT005] best-effort shutdown
                pass
