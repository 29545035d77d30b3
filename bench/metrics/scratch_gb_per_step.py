"""Gigabytes of full scratch rank 0's launches wrote a step: each traced
call's ``exec_info`` ``rank_timings`` ``scratch_bytes`` (the change of
``codegen_cuda.scratch_counts`` over the call), over the traced steps;
nothing where the record has no such count."""


def read(ctx):
    t = ctx["ranks"][0].get("trace") or {}
    timings = [i["rank_timings"] for i in t.get("exec_info") or () if "rank_timings" in i]
    if not timings or not t.get("steps") or any("scratch_bytes" not in r for r in timings):
        return None
    return sum(r["scratch_bytes"] for r in timings) / t["steps"] / 1e9
