"""One CUDA graph per group-loop signature: the device solve's replay cache.

``tpu._run_scan`` issues a PyTorch operation per tensor step of every
group step (48,255 launches for a 50,000-pod zone-spread solve) and reads
nothing back: its branches are host flags and tensor shapes.  So a loop
of one signature (:func:`scan_key`) launches the same kernels in the same
order on the same shapes every time, and is captured once and replayed.

:class:`ScanGraphs` is a bounded, signature-keyed cache that decides by
what it has seen, with no setting:

- **first sight** of a key: the loop runs eagerly, and the key is kept;
- **once its eager runs have cost what a capture costs** (the second sight
  until a capture has been measured): the loop is captured into a graph
  over static input buffers, and the graph is replayed;
- **after that**: replay only.  The inputs are copied into the static
  buffers (a stride-0 expanded input is materialised there), the graph is
  launched, and the outputs are cloned off its static outputs, so a later
  replay never overwrites a result a caller has not read yet.

A capture issues the whole loop once more and instantiates a graph of
tens of thousands of nodes, so on the card it costs several eager runs of
its key.  The cache measures that on the host's clock, as
``capture_runs``: the last capture's seconds over the seconds its loop
took to issue inside it, a stand-in for an eager run of the key that
leaves out a process's one-time loads (a many-slot loop issues slower
under capture, so the ratio reads low there: PERF.md §7).  A key is
captured once the eager runs it has made (``r``) pay for the capture's
excess over one eager run, ``r >= capture_runs - 1``, and at the
earliest at its second sight.  That is the rent-or-buy rule: a key
seen a few times costs at most about twice what running it eagerly
would, and a key that keeps recurring is replayed from then on.  A
one-off shape (a slot-exhaustion retry, a residue wave, a what-if
repack) therefore costs nothing more than before.  The graphs and the
keys seen but not captured are each bounded by the cache's ``capacity``,
least recently used out first.

A capture runs on the calling thread in ``thread_local`` mode (another
thread may read back or run a loop eagerly meanwhile), on a side stream
of the cache (a capture cannot run on the legacy default stream), one
capture at a time.  It calls ``capture_begin`` / ``capture_end`` itself:
``torch.cuda.graph`` synchronizes the whole device and empties the
allocator's cache on entry, which would stall every other thread on the
card.  Copy-in, replay and clone-out of one graph are enqueued under its
lock, and the caller's stream first waits on the event recorded after
the previous clone-out, so two replays of one graph never overlap.

Counts: a graph keeps the kernel-entry launches its capture recorded
(``kernels.tally``) and each replay adds them to ``Kernel.launches``; the
registry's ``karpenter_solver_scan_graph_replays`` observes 1.0 for a loop
served by a replay and 0.0 for an eager or a capturing one.  Only loops
on CUDA tensors reach the cache (``TpuSolver._scan``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence

import torch

from .. import kernels
from ..metrics import SCAN_GRAPH_REPLAYS
from ..obs.trace import NULL_TRACE

#: the per-group host flags of ``tpu._branch_flags`` a loop branches on
FLAG_NAMES = ("zoned_any", "zoned_all", "zpa_any", "hpa_any")


def scan_key(consts: Dict[str, torch.Tensor], init: Sequence[torch.Tensor],
             track: bool, flags: dict) -> tuple:
    """The signature of one group loop: the device, every const's and
    carry tensor's shape and dtype (they carry B, G, C, D, R, NR, NE_pad,
    S, P and Z), ``track`` and the four per-group flag tuples.  Nothing
    else changes what the loop launches."""
    return (
        str(consts["counts"].device), bool(track),
        tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(consts.items())),
        tuple((tuple(t.shape), t.dtype) for t in init),
        tuple(tuple(bool(f) for f in flags[n]) for n in FLAG_NAMES),
    )


def _stream(device: torch.device):
    return torch.cuda.current_stream(device) if device.type == "cuda" \
        else None


class _Graph:
    """One signature's loop: the graph, its static inputs, and the static
    outputs and kernel-entry launches its capture recorded."""

    def __init__(self, graph, consts: Dict[str, torch.Tensor],
                 init: Sequence[torch.Tensor]) -> None:
        self.graph = graph
        self.device = consts["counts"].device
        self.consts = {k: torch.empty(v.shape, dtype=v.dtype,
                                      device=v.device)
                       for k, v in consts.items()}
        self.init = tuple(torch.empty(t.shape, dtype=t.dtype,
                                      device=t.device) for t in init)
        self.out = None           # (carry, ys) of the capture
        self.fills: Dict[kernels.Kernel, int] = {}
        self.done = None          # event after the last clone-out
        self.lock = threading.Lock()

    def load(self, consts: Dict[str, torch.Tensor],
             init: Sequence[torch.Tensor]) -> None:
        for k, v in consts.items():
            self.consts[k].copy_(v)
        for buf, t in zip(self.init, init):
            buf.copy_(t)

    def outputs(self):
        carry, ys = self.out
        return (tuple(x.clone() for x in carry),
                ys.clone() if ys is not None else None)

    def retire(self) -> None:
        """Wait for the last replay enqueued, then let go of the graph
        and its buffers (eviction)."""
        with self.lock:
            if self.done is not None:
                self.done.synchronize()
            self.graph = self.out = None
            self.consts, self.init = {}, ()


class ScanGraphs:
    """The bounded, signature-keyed graph cache of one solver (module
    docstring).  ``new_graph()`` makes an empty graph with the
    ``capture_begin`` / ``capture_end`` / ``replay`` methods of
    ``torch.cuda.CUDAGraph``; ``registry`` receives the replay
    histogram."""

    def __init__(self, capacity: int, new_graph: Callable[[], object],
                 registry=None, clock: Callable[[], float] = time.perf_counter
                 ) -> None:
        self.capacity = capacity
        self._new_graph = new_graph
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        # key -> eager runs of a key not captured yet
        self._seen: OrderedDict = OrderedDict()    # guarded-by: _lock
        self._graphs: OrderedDict = OrderedDict()  # guarded-by: _lock
        # the last capture's cost in eager runs of its key (1 until one
        # is measured: the first capture comes at a key's second sight)
        self.capture_runs = 1.0                    # guarded-by: _lock
        # one capture at a time: captures share the side stream
        self._capture_lock = threading.Lock()
        self._side: Dict[str, object] = {}  # guarded-by: _capture_lock

    def graphs(self) -> int:
        with self._lock:
            return len(self._graphs)

    def seen(self) -> int:
        with self._lock:
            return len(self._seen)

    def run(self, key: tuple, consts: Dict[str, torch.Tensor],
            init: Sequence[torch.Tensor], scan: Callable, trace=NULL_TRACE):
        """``scan(consts, init)`` -> ``(carry, ys)``, served as the key's
        sight decides: eagerly, by a capture and its first replay, or by
        a replay."""
        entry = self._admit(key, consts, init)
        if entry is not None:
            with entry.lock:
                if entry.graph is not None:
                    replayed = entry.out is not None
                    try:
                        out = (self._replay(entry, consts, init, trace)
                               if replayed else
                               self._capture(entry, consts, init, scan,
                                             trace))
                    except BaseException:
                        if not replayed:
                            self._drop(key, entry)
                        raise
                    self._observe(1.0 if replayed else 0.0)
                    return out
        # not captured (yet), or the graph was evicted since its admission
        self._observe(0.0)
        return scan(consts, init)

    def _observe(self, value: float) -> None:
        # the series is born at the first loop on the card: a host-only
        # registry keeps the reference's series
        if self._registry is not None:
            self._registry.histogram(SCAN_GRAPH_REPLAYS).observe(value)

    def _admit(self, key, consts, init) -> Optional[_Graph]:
        """The key's graph, made empty once the key's eager runs pay for
        a capture (module docstring), the least recently used one evicted
        past ``capacity``; None while the key runs eagerly."""
        evicted = None
        with self._lock:
            entry = self._graphs.get(key)
            if entry is not None:
                self._graphs.move_to_end(key)
                return entry
            ran = self._seen.get(key)
            if ran is None:
                self._seen[key] = 1
                if len(self._seen) > self.capacity:
                    self._seen.popitem(last=False)
                return None
            self._seen.move_to_end(key)
            if ran < max(1.0, self.capture_runs - 1.0):
                self._seen[key] = ran + 1
                return None
            del self._seen[key]
            entry = self._graphs[key] = _Graph(self._new_graph(), consts,
                                               init)
            if len(self._graphs) > self.capacity:
                _k, evicted = self._graphs.popitem(last=False)
        if evicted is not None:
            evicted.retire()
        return entry

    def _drop(self, key, entry: _Graph) -> None:
        """Forget a graph whose capture failed (the caller raises)."""
        with self._lock:
            if self._graphs.get(key) is entry:
                del self._graphs[key]
        entry.graph = entry.out = None

    def _capture(self, entry: _Graph, consts, init, scan, trace):
        t0 = self._clock()
        with trace.span("scan.capture"):
            stream = self._enter(entry, consts, init)
            with self._capture_lock:
                side = None
                if stream is not None:
                    side = self._side.get(str(entry.device))
                    if side is None:
                        side = self._side[str(entry.device)] = \
                            torch.cuda.Stream(device=entry.device)
                    side.wait_stream(stream)
                with (torch.cuda.stream(side) if side is not None
                      else contextlib.nullcontext()), \
                        kernels.tally() as fills:
                    entry.graph.capture_begin(
                        capture_error_mode="thread_local")
                    try:
                        t_issue = self._clock()
                        out = scan(entry.consts, entry.init)
                        t_issue = self._clock() - t_issue
                    finally:
                        entry.graph.capture_end()
                if side is not None:
                    stream.wait_stream(side)
            entry.out, entry.fills = out, dict(fills)
            # the capture recorded the launches and counted them once:
            # this first replay runs them
            entry.graph.replay()
            out = self._leave(entry, stream)
        if t_issue > 0:
            with self._lock:
                self.capture_runs = (self._clock() - t0) / t_issue
        return out

    def _replay(self, entry: _Graph, consts, init, trace):
        with trace.span("scan.replay"):
            stream = self._enter(entry, consts, init)
            entry.graph.replay()
            for k, n in entry.fills.items():
                k.count_launch(n)
            return self._leave(entry, stream)

    @staticmethod
    def _enter(entry: _Graph, consts, init):
        """The caller's stream, after the graph's previous user, with the
        inputs copied into the static buffers."""
        stream = _stream(entry.device)
        if stream is not None and entry.done is not None:
            stream.wait_event(entry.done)
        entry.load(consts, init)
        return stream

    @staticmethod
    def _leave(entry: _Graph, stream):
        out = entry.outputs()
        if stream is not None:
            entry.done = stream.record_event()
        return out
