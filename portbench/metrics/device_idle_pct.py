"""device_idle_pct: the share of the traced window in which a card runs
no kernel, copy or set, averaged over the cards."""


def read(run):
    t = run.trace
    if t is None or not t.devices or t.window_s <= 0:
        return None
    return 100.0 * sum(t.idle_s(d) for d in t.devices) / len(t.devices) / t.window_s
