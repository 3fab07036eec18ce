"""The hierarchical solve's host stages per served request: the union of
each request's ``hier.partition``, ``hier.entries`` and ``hier.merge``
spans (coupling components and blocks, the block entries, the merge of
the blocks' plans), clipped to the request, total over requests; None
where no request has such a span (a program that does not open them)."""

from benchmark.tracing import covered

NAMES = ("hier.partition", "hier.entries", "hier.merge")


def read(run):
    reqs = [r for r in run.served if r.spans]
    if not any(nm in NAMES for r in reqs for nm, *_ in r.spans):
        return None
    total = sum(covered([(a, b) for nm, a, b, _ in r.spans if nm in NAMES],
                        r.t0, r.t1) for r in reqs)
    return total / len(reqs) * 1000.0
