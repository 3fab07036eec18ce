"""One caller in a closed loop on ``BatchScheduler.solve``.

Each call offers the next of the run's pending sets, in turn, as fresh
pod objects that set-up copied before the window (``Context.offers``).
Nothing but the calls runs between the first call's start and the last
call's return, which is the window: the returned plans are turned into
plain records after it.  The window ends with the call that takes it
past ``seconds``.
"""

from __future__ import annotations

import time

from ..harness import Request
from ..tracing import ReqTrace


class Driver:
    def __init__(self, ctx) -> None:
        from karpenter_tpu_torch.metrics import Registry
        from karpenter_tpu_torch.solver.scheduler import BatchScheduler

        self.ctx = ctx
        self.registry = Registry()
        self.sched = BatchScheduler(backend=ctx.traffic["backend"],
                                    registry=self.registry,
                                    device=ctx.device)

    def _call(self, traced: bool) -> Request:
        ctx = self.ctx
        s, tag, pods = ctx.next_offer()
        trace = ReqTrace() if traced else None
        t0 = time.perf_counter()
        try:
            res = self.sched.solve(pods, [ctx.provisioner],
                                   ctx.instance_types, trace=trace)
        except Exception as err:  # noqa: BLE001 — judged, not raised
            return Request(s, tag, len(pods), t0, time.perf_counter(),
                           trace, error=repr(err))
        t1 = time.perf_counter()
        if trace is not None:
            trace.t0, trace.t1 = t0, t1
        return Request(s, tag, len(pods), t0, t1, trace, result=res)

    def warm(self) -> None:
        """One solve of the first set: the device path at the cell's own
        shapes (every set has the same deployments, nodes and catalog).
        The other sets' first offers fill the tensorize cache inside the
        window, as new deployments do in a provisioning loop: the same
        work in every run."""
        req = self._call(False)
        if req.error:
            raise RuntimeError(f"the warm-up solve failed: {req.error}")

    def window(self, seconds: float, traced: bool):
        reqs = [self._call(traced)]
        while reqs[-1].t1 - reqs[0].t0 < seconds:
            reqs.append(self._call(traced))
        return reqs, reqs[-1].t1 - reqs[0].t0

    def stretch(self, n: int, sync):
        """``n`` traced calls back to back between two device-wide
        synchronizes (the profiled stretch)."""
        t_sync = time.perf_counter()
        sync()
        reqs = [self._call(True) for _ in range(n)]
        sync()
        return reqs, t_sync, time.perf_counter()

    def close(self) -> None:
        self.sched.stop_warms()
