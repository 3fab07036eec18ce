"""The hierarchical solve's cross-block tail repack per served request:
the union of each request's ``hier.tail`` spans (the fill scan, the
re-seat of the tails' pods through the flat solve and the choice of the
cheaper plan), clipped to the request, total over requests."""

from benchmark.spans import ms_per_request


def read(run):
    return ms_per_request(run, "hier.tail")
