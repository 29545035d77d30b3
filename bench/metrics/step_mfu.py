"""The whole step's share of the card's peak: the step's least time on one
card (``bench/count.py``, from the configuration's work) over the measured
time a step (rank 0's window), in %."""

from bench import count


def read(ctx):
    r0 = ctx["ranks"][0]
    if not r0.get("steps"):
        return None
    return 100.0 * count.least_seconds(ctx["spec"]["cfg"])["seconds"] / (r0["window_s"] / r0["steps"])
