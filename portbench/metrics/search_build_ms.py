"""search_build_ms: the program's ``search.build`` span (the ``Search``
built from the hashes) per traced search, in ms."""

from portbench import spans


def read(run):
    return spans.per_search(run, lambda root, under: spans.named(under, "search.build"))
