"""Gigabytes of latent cache ``mla.attend`` reads a decode step: the device
probe's count ``mla.latent_bytes`` over the traced steps.  The count is what
the code reads: ``attention.attend_latent`` reads every allocated row of
the cache (the rows past the position masked), the latent twice (scores,
then the weighted sum) and the rope key once, so at this cell (64 rows,
7168 + 16 positions allocated, 27 layers, latent 512, rope 64, bfloat16) it
is 64 * 7184 * 27 * (2 * 512 + 64) * 2 B = 27.012759552 GB a step.  A
reader of rows 0 .. p alone, each once, would read
64 * 7176.5 * 27 * 1152 B = 14.285942784 GB."""

from bench.metrics._lm import probe


def read(ctx):
    got = probe(ctx)
    if got is None or "mla.latent_bytes" not in got[0]["counts"]:
        return None
    lm, steps = got
    return lm["counts"]["mla.latent_bytes"] / steps / 1e9
