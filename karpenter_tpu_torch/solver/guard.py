"""Hang protection for the in-process device tier.

The port of the reference package's ``solver/guard.py``.  One device call
that never returns (a wedged card, a kernel that spins, a driver stall)
must not freeze the reconcile loop: the scheduler's ``auto`` policy
dispatches its device calls through :class:`DeviceGuard`, which runs each
call on an expendable daemon thread and abandons it on timeout:

- the device tier is latched **unhealthy** and the scheduler serves every
  following batch from the warm host tiers (native C++ / CPU oracle);
- a background probe thread re-runs a tiny op on the scheduler's device
  until it answers, then re-enables the device tier.  The probe reads its
  result back to the host, so it queues behind whatever the card is still
  running: it answers only once the abandoned work has drained;
- the abandoned call thread cannot be killed (it is blocked inside the
  CUDA runtime); it is daemonized so it never pins process exit, and the
  unhealthy latch bounds the leak at one abandoned call thread plus one
  probe thread per outage.

A :class:`DeviceHang` raised INSIDE a guarded call (the fault plane's
injected ``device_hang``, or a nested guard's own trip) latches the tier
the same way before it propagates: a hang the guard did not time out
itself is still a hang.  The reference re-raises it without latching.

Snapshot isolation makes abandonment safe: solvers place pods on their own
snapshots of the caller's nodes (``SimNode.snapshot``), and every dispatch
uploads into tensors of its own, so a timed-out solve that completes later
writes nothing the live scheduler still reads.
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
from typing import Callable, List, Optional

logger = logging.getLogger(__name__)

#: abandoned call threads, joined briefly at interpreter exit: give a
#: just-slow call a moment to drain, but never pin exit on a truly wedged
#: device (that is the guard's whole point)
_ABANDONED: List[threading.Thread] = []
_EXIT_GRACE_S = 5.0


@atexit.register
def _drain_abandoned() -> None:
    import time as _time

    deadline = _EXIT_GRACE_S
    for t in _ABANDONED:
        if deadline <= 0:
            break
        # ktlint: allow[KT002] interpreter-exit drain deadline: runs from
        # atexit after the controllers (and their injected clocks) are gone,
        # and a fake-advanced clock must never shorten the real join grace
        t0 = _time.monotonic()
        t.join(deadline)
        deadline -= _time.monotonic() - t0  # ktlint: allow[KT002] see above

#: default guard timeout, the reference's.  The reference sized it for
#: compiled device programs of milliseconds to seconds; the port's group
#: loops are launch-bound and slower on the card (PERF.md §5 reads each
#: guarded call's wall against it).  Override with
#: ``KT_DEVICE_SOLVE_TIMEOUT_S``; 0 disables the guard.
DEFAULT_TIMEOUT_S = 180.0


class DeviceHang(Exception):
    """A guarded device call exceeded its deadline (wedged device?)."""


def device_probe(device=None) -> Callable[[], None]:
    """The recovery probe for ``device`` (``None``: the CUDA card, resolved
    when the probe runs): a small op on that device read back to the host —
    on a wedged card the read blocks, so the probe answers only once the
    card runs work again."""

    # ktlint: fence the probe IS a device read: it answers only once the
    # card runs work again
    def probe() -> None:
        import torch

        from ..device import resolve_device

        torch.zeros(4, device=resolve_device(device)).sum().item()

    return probe


class DeviceGuard:
    def __init__(
        self,
        timeout_s: Optional[float] = None,
        probe_interval_s: float = 30.0,
        probe_fn: Optional[Callable[[], None]] = None,
        on_health_change: Optional[Callable[[bool], None]] = None,
        device=None,
    ) -> None:
        if timeout_s is None:
            timeout_s = float(
                os.environ.get("KT_DEVICE_SOLVE_TIMEOUT_S", DEFAULT_TIMEOUT_S)
            )
        self.timeout_s = timeout_s
        self.probe_interval_s = probe_interval_s
        self.probe_fn = probe_fn if probe_fn is not None else \
            device_probe(device)
        self.on_health_change = on_health_change
        self._lock = threading.Lock()
        self._healthy = True
        self._probing = False
        self._stop = threading.Event()

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    @property
    def healthy(self) -> bool:
        return self._healthy

    def run(self, fn, *args, **kwargs):
        """Run ``fn`` with the hang deadline; raise :class:`DeviceHang` on
        timeout (latching unhealthy), else return/raise exactly what ``fn``
        did (a :class:`DeviceHang` from ``fn`` latches too)."""
        return self._run(self.timeout_s, fn, args, kwargs)

    def run_budgeted(self, fn, *args, budget_frac: float = 1.0, **kwargs):
        """Like :meth:`run` with ``budget_frac`` of the deadline.  The
        hierarchical solver dispatches up to ``1 + KT_HIER_PRICE_ITERS``
        block waves per batch; splitting the whole-solve deadline across
        them keeps a wedged device latching in the same bounded time as one
        flat solve instead of ``waves x`` longer."""
        frac = min(max(budget_frac, 0.0), 1.0)
        return self._run(self.timeout_s * frac, fn, args, kwargs)

    def _run(self, timeout_s: float, fn, args, kwargs):
        if not self.enabled or timeout_s <= 0:
            return fn(*args, **kwargs)
        box: dict = {}
        done = threading.Event()

        def work():
            try:
                box["val"] = fn(*args, **kwargs)
            # ktlint: allow[KT005] the expendable call thread boxes EVERY
            # outcome (incl. KeyboardInterrupt) and run() re-raises it on
            # the caller thread — swallowing here would turn a device error
            # into a phantom hang
            except BaseException as e:  # noqa: BLE001 — re-raised in caller
                box["err"] = e
            finally:
                done.set()

        t = threading.Thread(target=work, daemon=True, name="kt-device-call")
        t.start()
        if not done.wait(timeout_s):
            _ABANDONED.append(t)
            self._mark_unhealthy(f"a device call hung past {timeout_s:.0f}s")
            raise DeviceHang(
                f"device call exceeded {timeout_s:.0f}s; device tier "
                "latched unhealthy (warm host tiers serve until a probe "
                "succeeds)"
            )
        if "err" in box:
            if isinstance(box["err"], DeviceHang):
                self._mark_unhealthy(f"a device call raised {box['err']}")
            raise box["err"]
        return box["val"]

    def stop(self) -> None:
        """Stop the recovery probe (shutdown)."""
        self._stop.set()

    # ---- internals -----------------------------------------------------
    def _mark_unhealthy(self, why: str) -> None:
        with self._lock:
            if not self._healthy:
                return
            self._healthy = False
            start_probe = not self._probing
            self._probing = True
            # callback under the lock: a recovery racing this transition
            # must not interleave its on_health_change(True) after ours and
            # leave the health gauge reading 1 through a real outage
            if self.on_health_change:
                self.on_health_change(False)
        logger.error(
            "device tier UNHEALTHY: %s; solves degrade to the warm host "
            "tiers until a probe succeeds", why,
        )
        if start_probe:
            threading.Thread(
                target=self._probe_loop, daemon=True, name="kt-device-probe"
            ).start()

    def _probe_loop(self) -> None:
        # The probe op runs inline in this thread: if the device is still
        # wedged the op blocks HERE (no new probe threads pile up), and when
        # the device drains the blocked op completes and recovery follows
        # on the next iteration — hung-then-recovered needs no extra timer.
        while not self._stop.wait(self.probe_interval_s):
            try:
                self.probe_fn()
            except Exception as e:  # noqa: BLE001 — probe failure = still down
                logger.debug("device probe failed: %r", e)
                continue
            with self._lock:
                self._healthy = True
                self._probing = False
                if self.on_health_change:
                    self.on_health_change(True)  # under the lock, see above
            logger.info(
                "device tier RECOVERED: probe op answered; device solves "
                "re-enabled"
            )
            return
