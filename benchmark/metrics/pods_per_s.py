"""Pods planned per second: the pods of every request the window served,
over the window's whole time."""


def read(run):
    if run.window_s <= 0 or not run.served:
        return None
    return sum(r.pods for r in run.served) / run.window_s
