"""The scheduler's host stages per served request: each request's wall,
less the time its queue wait (``window``), ``tensorize`` and device-solve
spans (``device_execute``, ``device_dispatch``, ``device_fence``,
``megabatch``) cover, total over requests."""

NOT_HOST = ("window", "tensorize", "device_execute", "device_dispatch",
            "device_fence", "megabatch")


def _covered(iv):
    total, end = 0.0, None
    for a, b in sorted(iv):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def read(run):
    reqs = [r for r in run.served if r.spans]
    if not reqs:
        return None
    total = 0.0
    for r in reqs:
        iv = [(max(a, r.t0), min(b, r.t1)) for nm, a, b, _ in r.spans
              if nm in NOT_HOST and min(b, r.t1) > max(a, r.t0)]
        total += (r.t1 - r.t0) - _covered(iv)
    return total / len(reqs) * 1000.0
