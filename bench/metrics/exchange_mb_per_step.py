"""Megabytes of halo stripes rank 0 sent and received a step over the
profiled window (the session's ``messages`` counter:
``parallel.halo.message_counts``, ``send_bytes`` and ``recv_bytes``);
nothing where the counter has no bytes or no exchange ran."""


def read(ctx):
    t = ctx["ranks"][0].get("trace") or {}
    msgs = (t.get("counters") or {}).get("messages") or {}
    if not msgs.get("exchanges") or "send_bytes" not in msgs or not t.get("steps"):
        return None
    return (msgs["send_bytes"] + msgs["recv_bytes"]) / t["steps"] / 1e6
