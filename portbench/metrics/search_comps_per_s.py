"""search_comps_per_s: the in-band pairs ``i < j < bounds[i]`` of every
search completed in the window, over the window: from the first timed
search's start to the end of the last one started before ``--seconds``."""


def read(run):
    if not run.calls or run.trace is not None:
        return None
    return run.comps_per_call * len(run.calls) / run.window_s
