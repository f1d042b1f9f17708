"""setup_s: seconds from the start of the run's process (its harness)
to the first timed call: the library made from the seed, the program's
objects, its kernels built or loaded, and the warm-up calls."""


def read(run):
    return run.setup_s
