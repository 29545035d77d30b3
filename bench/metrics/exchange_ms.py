"""The halo exchanges' time a step (each traced call's ``exec_info``
``rank_timings``: the program's CUDA events around each exchange), the
largest over the ranks, in ms."""


def _rank(t):
    timings = [i["rank_timings"] for i in t.get("exec_info") or () if "rank_timings" in i]
    if not timings or not t.get("steps"):
        return None
    return 1e3 * sum(r["exchange_seconds"] for r in timings) / t["steps"]


def read(ctx):
    per_rank = [_rank(r.get("trace") or {}) for r in ctx["ranks"]]
    return None if None in per_rank else max(per_rank)
