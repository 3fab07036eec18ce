"""Per-request span sums of a traced run, for the metric readers."""

from __future__ import annotations

from .tracing import covered


def ms_per_request(run, name: str):
    """The union of each served request's ``name`` spans, clipped to the
    request's interval, in ms per traced request; None where no request
    has such a span (a program that does not open it)."""
    reqs = [r for r in run.served if r.spans]
    if not any(nm == name for r in reqs for nm, *_ in r.spans):
        return None
    total = sum(covered([(a, b) for nm, a, b, _ in r.spans if nm == name],
                        r.t0, r.t1) for r in reqs)
    return total / len(reqs) * 1000.0
