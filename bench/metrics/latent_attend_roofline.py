"""The latent attention's share of its roofline: the latent cache a decode
step needs (``bench/count_lm.py``: rows 0 .. p of every layer, each once)
over 3.35 TB/s, over the device time of ``mla.attend`` a step (CUDA events
at the span's bounds, the traced window), in %."""

from bench import count_lm
from bench.metrics._lm import probe


def read(ctx):
    got = probe(ctx)
    if got is None or not got[0]["seconds"].get("mla.attend"):
        return None
    lm, steps = got
    spec = ctx["spec"]
    need = count_lm.latent_bytes(spec["cfg"], int(spec["traffic"]["steps_per_call"]))
    return 100.0 * need / count_lm.HBM_BYTES_PER_S / (lm["seconds"]["mla.attend"] / steps)
