"""The share of the window's group loops on the card that a replay of
their signature's captured CUDA graph served: the sum of the program's
``karpenter_solver_scan_graph_replays`` (1 for a replay, 0 for an eager
or a capturing loop) over its count.  None where the histogram counted
no loop in the window: a program without the graphs, or a host run."""

NAME = "karpenter_solver_scan_graph_replays"


def read(run):
    total, count = run.hist_delta.get(NAME, (0.0, 0))
    if not count:
        return None
    return total / count
