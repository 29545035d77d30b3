"""What the LM decode cell's readers share: the traced window's device
probe record (``counters["lm"]`` of ``bench/drivers/lm_decode.py``) and its
steps."""


def probe(ctx):
    """(the probe's record, the traced steps), or None where the run has no such record."""
    t = ctx["ranks"][0].get("trace") or {}
    lm = (t.get("counters") or {}).get("lm")
    if not lm or not t.get("steps"):
        return None
    return lm, t["steps"]
