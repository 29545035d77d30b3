"""The kernels' share of their roofline: the step's least time on one card
(``bench/count.py``) times the profiled window's steps, over the card's
kernel time in that window (NCCL's kernels excluded), averaged over the
ranks, in %."""

from bench import count


def read(ctx):
    tr = [r.get("trace") or {} for r in ctx["ranks"]]
    if not all(t.get("kernel_s") for t in tr):
        return None
    kernel_s = sum(t["kernel_s"] for t in tr) / len(tr)
    return 100.0 * count.least_seconds(ctx["spec"]["cfg"])["seconds"] * tr[0]["steps"] / kernel_s
