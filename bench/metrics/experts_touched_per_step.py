"""Distinct routed experts a MoE layer's decode step touches, averaged over
the traced window's MoE layer calls (the device probe's
``moe.experts_touched`` over ``moe.layer_calls``).  With 64 tokens routed
6 ways over 64 experts evenly, about 63.9."""

from bench.metrics._lm import probe


def read(ctx):
    got = probe(ctx)
    if got is None or not got[0]["counts"].get("moe.layer_calls"):
        return None
    counts = got[0]["counts"]
    return counts["moe.experts_touched"] / counts["moe.layer_calls"]
