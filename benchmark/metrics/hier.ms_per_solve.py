"""The hierarchical solve's wall per served request: the sum of the
program's ``karpenter_solver_hier_duration_seconds`` over the window, in
ms, per served request.  None where the histogram counted no solve in
the window, or fewer than the window served: a request that left the
hierarchical route (the flat fallbacks observe nothing)."""

NAME = "karpenter_solver_hier_duration_seconds"


def read(run):
    total, count = run.hist_delta.get(NAME, (0.0, 0))
    served = len(run.served)
    if not count or count != served:
        return None
    return total / served * 1000.0
