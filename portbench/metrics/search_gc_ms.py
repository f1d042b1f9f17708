"""search_gc_ms: the cyclic GC's time inside the program's ``search``
span (its ``gc_ns``) per traced search, in ms; it falls inside the other
spans, so it overlaps them."""

from portbench import spans


def read(run):
    return spans.per_search(run, lambda root, under: root.gc_ns)
