"""The generated kernels' launches a step over the profiled window, rank 0
(the session's ``launches`` counter: ``codegen_cuda.launch_counts``)."""


def read(ctx):
    t = ctx["ranks"][0].get("trace") or {}
    launches = (t.get("counters") or {}).get("launches")
    return sum(launches.values()) / t["steps"] if launches is not None and t.get("steps") else None
