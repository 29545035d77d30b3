"""The host's own time to issue a step: a call begun right after a
synchronize, timed on the host clock until it returns, over its steps; the
median of the bursts, rank 0, in ms."""


def read(ctx):
    t = ctx["ranks"][0].get("trace") or {}
    return 1e3 * t["host_s_per_step"] if t.get("host_s_per_step") is not None else None
