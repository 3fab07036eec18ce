"""CUDA kernel launches per served request in the profiled stretch."""


def read(run):
    p = run.profile
    if not p or not p["solves"] or not p["launches"]:
        return None
    return p["launches"] / p["solves"]
