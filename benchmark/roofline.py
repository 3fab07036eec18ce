"""The least time the device solve of one pending set could take, from
the problem's own shapes, and the card's peaks.

The group loop reads each input once and writes each output once, in
float32: the groups' requests (G x R) and counts (G), every candidate
offering's allocatable (C x R) and price (C), the groups' spread counts
per zone (G x D); it writes the node rows (NR x (R + 2): what each node
holds, its type and its zone) and the placements (G x NR).  Its least
operations: one fit test per resource of every group against every
candidate (G x C x R) and one update per resource of every pod placed.
NR is the node count of the reference's own plan of the set, so the
count is the same whatever implements the loop.
"""

from __future__ import annotations

#: NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                              "float32_per_s": 67e12},
}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"

BYTES = 4  # float32


def loop_work(pending: dict, n_candidates: int, n_zones: int,
              n_nodes: int, n_resources: int = 3) -> tuple:
    """``(bytes, operations)`` of the group loop over one set."""
    G = len(pending["deployments"])
    pods = sum(d["replicas"] for d in pending["deployments"])
    R, C, D, NR = n_resources, n_candidates, n_zones, n_nodes
    values = G * R + G + C * R + C + G * D + NR * (R + 2) + G * NR
    return values * BYTES, G * C * R + pods * R


def least_seconds(nbytes: float, ops: float, kind: str) -> tuple:
    """``(seconds, bound)``: the larger of bytes over the memory peak and
    operations over the float32 peak, with which one bounds it."""
    peak = PEAKS.get(kind, PEAKS[DEFAULT_PEAK])
    t_bytes = nbytes / peak["bytes_per_s"]
    t_ops = ops / peak["float32_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")
