"""The hierarchical solve's block waves per served request: the union of
each request's ``hier.wave`` spans (every batched dispatch of the blocks,
the first and the price loop's re-solves, with their extracts), clipped
to the request, total over requests."""

from benchmark.spans import ms_per_request


def read(run):
    return ms_per_request(run, "hier.wave")
