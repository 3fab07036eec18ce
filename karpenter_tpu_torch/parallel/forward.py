"""Cross-host megabatch result forwarding, single host only: the port of
the reference package's ``parallel/forward.py``.

On a multi-process mesh the reference's per-host fence resolves a request
whose slot another host owns to the typed :class:`SlotNotOwned`, and this
shim re-sends it to the owning host's serving endpoint.  The port has no
mesh yet (ROADMAP A10) and no gRPC client (ROADMAP A8b), so a port
process never produces a foreign slot: the forwarder is built disabled,
and a foreign slot, should one reach it, surfaces its typed error
(counted ``unrouted``).  ``KT_MULTIHOST_PEERS`` (the owning hosts'
endpoints) is refused at construction with :class:`MultiHostNotPorted`
rather than silently serving every request locally.

Tests inject ``transport=`` (a callable ``(endpoint, kwargs) -> SolveResult``)
so the routing/demux contract is pinned without a live fleet.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional

from ..obs.trace import NULL_TRACE

logger = logging.getLogger(__name__)


class SlotNotOwned(RuntimeError):
    """A megabatch slot this process holds no addressable shard of: the
    per-host fence (solver/tpu.py ``PendingMegaSolve.results``) boxes this
    into the slot's position instead of paying DCN to read it back.
    ``owner`` is the owning process index (-1 when unknown)."""

    def __init__(self, slot: int, owner: int = -1) -> None:
        super().__init__(
            f"megabatch slot {slot} is owned by process {owner}; this "
            "process fenced only its addressable shards")
        self.slot = int(slot)
        self.owner = int(owner)


class MultiHostNotPorted(NotImplementedError):
    """``KT_MULTIHOST_PEERS`` names peer hosts, but the port serves one host:
    the multi-process mesh is ROADMAP A10 and the gRPC client the forward
    rides is ROADMAP A8b."""


def _env_peers() -> List[str]:
    raw = os.environ.get("KT_MULTIHOST_PEERS", "")
    return [e.strip() for e in raw.split(",") if e.strip()]


class ResultForwarder:
    """Route a foreign-slot request to the owning host's serving endpoint.

    Only an injected ``transport`` forwards; without one the shim is
    disabled and ``forward()`` raises the original :class:`SlotNotOwned`
    (counted ``unrouted``).  Peer endpoints — ``peers=`` or
    ``KT_MULTIHOST_PEERS`` — raise :class:`MultiHostNotPorted`."""

    def __init__(self, peers: Optional[List[str]] = None, registry=None,
                 transport: Optional[Callable] = None,
                 enabled: Optional[bool] = None) -> None:
        self.peers = list(peers) if peers is not None else _env_peers()
        if self.peers and transport is None:
            raise MultiHostNotPorted(
                f"KT_MULTIHOST_PEERS={','.join(self.peers)!r}: cross-host "
                "result forwarding is not ported to karpenter_tpu_torch yet "
                "(the mesh is ROADMAP A10, the gRPC client ROADMAP A8b); "
                "unset it to serve from this host alone")
        self.registry = registry
        self.transport = transport
        if enabled is None:
            enabled = (os.environ.get("KT_MULTIHOST_FORWARD", "1") != "0"
                       and transport is not None)
        self._enabled = bool(enabled)

    def enabled(self) -> bool:
        return self._enabled

    def _count(self, outcome: str) -> None:
        if self.registry is None:
            return
        from ..metrics import MULTIHOST_FORWARDS

        self.registry.counter(MULTIHOST_FORWARDS).inc({"outcome": outcome})

    def zero_init(self) -> None:
        """KT003: every forward-outcome series exists at 0 from
        construction of the owning pipeline."""
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
            self._count("unrouted")
            raise err

    def close(self) -> None:
        """Nothing to release: the port holds no peer channels."""
