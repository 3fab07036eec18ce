"""Pods the hierarchical solve re-seated as stragglers per served
request: the sum of the program's ``karpenter_solver_hier_repair_pods``
over the window, per served request.  None where the histogram counted
no solve in the window, or fewer than the window served."""

NAME = "karpenter_solver_hier_repair_pods"


def read(run):
    total, count = run.hist_delta.get(NAME, (0.0, 0))
    served = len(run.served)
    if not count or count != served:
        return None
    return total / served
