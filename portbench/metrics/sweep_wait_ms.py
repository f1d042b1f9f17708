"""sweep_wait_ms: the program's ``sweep.wait`` spans (the host blocked on
the card: the hit list, the decode and the pairs' fetch) per traced
search, in ms."""

from portbench import spans


def read(run):
    return spans.per_search(run, lambda root, under: spans.waits_ns(under))
