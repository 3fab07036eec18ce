"""The host time that launches the group step's bisection fills
(``skew_band_fill`` / ``water_fill``) per served request: the union of
each request's ``step.fill`` spans, clipped to the request, total over
requests."""

from benchmark.spans import ms_per_request


def read(run):
    return ms_per_request(run, "step.fill")
