"""sweep_host_ms: the program's ``search.sweep`` span less its
``sweep.wait`` spans (the host's part of the sweep: the states, their
uploads, the launches and the decode's host work) per traced search, in
ms."""

from portbench import spans


def read(run):
    return spans.per_search(run, lambda root, under: spans.sweep_host_ns(under))
