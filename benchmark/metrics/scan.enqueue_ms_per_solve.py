"""The device solve's enqueue per served request: the union of each
request's ``device_enqueue`` spans (uploads, feasibility and the group
loop's launches, made from the host), clipped to the request, total
over requests."""

from benchmark.spans import ms_per_request


def read(run):
    return ms_per_request(run, "device_enqueue")
