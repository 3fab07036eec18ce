"""Process start to the first timed request: imports, the CUDA context,
the inputs, the scheduler and the warm-up at the cell's own shapes."""


def read(run):
    return run.setup_s
