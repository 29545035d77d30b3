"""The share of the profiled window in which the card ran no operation, the
largest over the ranks, in %."""


def read(ctx):
    tr = [r.get("trace") or {} for r in ctx["ranks"]]
    if not all(t.get("device_events") and t.get("window_s") for t in tr):
        return None
    return max(100.0 * (1.0 - t["busy_s"] / t["window_s"]) for t in tr)
