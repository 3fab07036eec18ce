"""The device solve per served request: ``device_execute`` (a
synchronous solve), ``device_dispatch`` + ``device_fence`` (one
dispatched alone) and ``megabatch`` (a flush's device phase, recorded on
each of its requests and shared among the flush's occupied slots),
total over requests."""

SOLO = ("device_execute", "device_dispatch", "device_fence")


def read(run):
    reqs = [r for r in run.served if r.spans]
    if not reqs:
        return None
    total = 0.0
    for r in reqs:
        for nm, a, b, share in r.spans:
            if nm in SOLO:
                total += b - a
            elif nm == "megabatch":
                total += (b - a) / max(1, share or 1)
    return total / len(reqs) * 1000.0
