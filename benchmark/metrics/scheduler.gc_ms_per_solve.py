"""The collector's pauses per served request: the union of each
request's ``gc`` spans (collections that ran on a thread the request was
bound to), clipped to the request, total over requests."""

from benchmark.spans import ms_per_request


def read(run):
    return ms_per_request(run, "gc")
