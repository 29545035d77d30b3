"""The decode step's share of the card's peak: its least time
(``bench/count_lm.py``: the larger of bytes over 3.35 TB/s and bf16
operations over 989 TFLOP/s, the bytes being the touched experts' weights,
every other weight and the latent cache rows 0 .. p, each once) over the
measured time a step (rank 0's untraced window), in %.  The touched
experts' bytes a step are the traced window's device count."""

from bench import count_lm
from bench.metrics._lm import probe


def read(ctx):
    got, r0 = probe(ctx), ctx["ranks"][0]
    if got is None or not r0.get("steps"):
        return None
    lm, steps = got
    expert = lm["counts"].get("moe.expert_bytes")
    if expert is None:
        return None
    spec = ctx["spec"]
    least = count_lm.least_seconds(spec["cfg"], int(spec["traffic"]["steps_per_call"]), expert / steps)
    return 100.0 * least["seconds"] / (r0["window_s"] / r0["steps"])
