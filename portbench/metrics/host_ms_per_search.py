"""host_ms_per_search: the busiest card's idle time in the traced window,
per search, in ms: what the host alone holds each search up by."""


def read(run):
    t = run.trace
    if t is None or not t.devices or not any(t.busy_s.values()):
        return None
    busiest = max(t.devices, key=lambda d: t.busy_s[d])
    return 1000.0 * t.idle_s(busiest) / t.calls
