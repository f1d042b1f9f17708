"""search_bounds_csr_ms: the program's ``search.bounds`` and
``search.csr`` spans (each row's window bound, and the adjacency's CSR
offsets) per traced search, in ms."""

from portbench import spans


def read(run):
    return spans.per_search(
        run, lambda root, under: spans.named(under, "search.bounds", "search.csr"))
