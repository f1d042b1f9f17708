"""search_replay_ms: the program's ``search.replay`` and
``search.groups`` spans (the greedy consume over the adjacency, and the
MatchGroups) per traced search, in ms."""

from portbench import spans


def read(run):
    return spans.per_search(
        run, lambda root, under: spans.named(under, "search.replay", "search.groups"))
