"""search_self_ms: the self time of the program's ``search`` span (its
duration less what its steps' spans cover) per traced search, in ms."""

from portbench import spans


def read(run):
    return spans.per_search(run, spans.self_ns)
