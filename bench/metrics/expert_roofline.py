"""The routed experts' share of their roofline: the bytes of the experts a
decode step's tokens touched (the device count ``moe.expert_bytes``) over
3.35 TB/s, over the device time of ``moe.experts`` a step (CUDA events at
the span's bounds, the traced window), in %."""

from bench import count_lm
from bench.metrics._lm import probe


def read(ctx):
    got = probe(ctx)
    if got is None or not got[0]["seconds"].get("moe.experts") or "moe.expert_bytes" not in got[0]["counts"]:
        return None
    lm, steps = got
    return 100.0 * lm["counts"]["moe.expert_bytes"] / count_lm.HBM_BYTES_PER_S / lm["seconds"]["moe.experts"]
