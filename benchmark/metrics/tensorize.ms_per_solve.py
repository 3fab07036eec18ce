"""Host tensorize per served request: the ``tensorize`` spans of the
window's requests, total over requests."""


def read(run):
    reqs = [r for r in run.served if r.spans]
    if not reqs:
        return None
    total = sum(b - a for r in reqs for nm, a, b, _ in r.spans
                if nm == "tensorize")
    return total / len(reqs) * 1000.0
