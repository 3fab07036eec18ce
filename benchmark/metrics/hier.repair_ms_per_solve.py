"""The hierarchical solve's straggler repair per served request: the
union of each request's ``hier.repair`` spans (the re-seat of the pods no
block placed, or an evicted node held, through the flat solve), clipped
to the request, total over requests."""

from benchmark.spans import ms_per_request


def read(run):
    return ms_per_request(run, "hier.repair")
