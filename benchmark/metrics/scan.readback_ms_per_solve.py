"""The device solve's read-back per served request: the union of each
request's ``device_readback`` spans (the fence and the device-to-host
copies, the host blocked on the device), clipped to the request, total
over requests."""

from benchmark.spans import ms_per_request


def read(run):
    return ms_per_request(run, "device_readback")
