"""The request's wall that no span names, per served request: each
request's wall less the union of all its spans, clipped to the request,
total over requests (the ``other`` of the idle gaps)."""

from benchmark.tracing import covered


def read(run):
    reqs = [r for r in run.served if r.spans]
    if not reqs:
        return None
    total = sum((r.t1 - r.t0)
                - covered([(a, b) for _nm, a, b, _ in r.spans], r.t0, r.t1)
                for r in reqs)
    return total / len(reqs) * 1000.0
