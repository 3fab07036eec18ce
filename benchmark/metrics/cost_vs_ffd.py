"""The $/hr of the nodes the window's plans buy, at the benchmark's
catalog prices, over the $/hr of the reference's own first-fit-decreasing
plans of the same pending sets."""


def read(run):
    if run.cost_reference <= 0:
        return None
    return run.cost_program / run.cost_reference
