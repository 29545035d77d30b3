"""The halo exchanges' steady wait a step: each traced call's ``exec_info``
``rank_timings`` ``steady_wait_seconds`` (the program's CUDA events on the
compute stream, from the end of each axis' pack to the end of its wait on
the transfer, the peers' lateness included, over the call's exchanges but
its first, scaled to all of them: the first waits out the ranks' skew at the
call's start), the largest over the ranks, in ms; nothing where the record
has no such timing."""

KEYS = ("steady_wait_seconds",)


def per_step_ms(t, keys):
    """ms a step of ``keys`` summed over one rank's traced calls; None where
    a call lacks one."""
    timings = [i["rank_timings"] for i in t.get("exec_info") or () if "rank_timings" in i]
    if not timings or not t.get("steps") or any(k not in r for r in timings for k in keys):
        return None
    return 1e3 * sum(r[k] for r in timings for k in keys) / t["steps"]


def largest_over_ranks(ctx, keys):
    per_rank = [per_step_ms(r.get("trace") or {}, keys) for r in ctx["ranks"]]
    return None if None in per_rank else max(per_rank)


def read(ctx):
    return largest_over_ranks(ctx, KEYS)
