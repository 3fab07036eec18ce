"""The group loop's share of its roofline, in %: the least time of the
stretch's solves (``roofline.loop_work`` over each request's pending
set, bytes over the memory peak or operations over the float32 peak,
whichever is larger) over the device time of the kernels launched inside
the device-solve spans."""


def read(run):
    p = run.profile
    if not p or p["kernel_s_in_solve"] <= 0 or p["least_s"] <= 0:
        return None
    return 100.0 * p["least_s"] / p["kernel_s_in_solve"]
