"""Point-to-point messages a step that rank 0 posted, sent and received,
over the profiled window (the session's ``messages`` counter:
``parallel.halo.message_counts``); nothing where no exchange ran."""


def read(ctx):
    t = ctx["ranks"][0].get("trace") or {}
    msgs = (t.get("counters") or {}).get("messages")
    if not msgs or not msgs.get("exchanges") or not t.get("steps"):
        return None
    return (msgs["send"] + msgs["recv"]) / t["steps"]
