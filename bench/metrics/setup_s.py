"""Set-up: process start to the first timed step (imports, planning, the
fields from the seed, the first call, which compiles where nothing is
cached, and the calls that size the window), rank 0, in s."""


def read(ctx):
    return ctx["ranks"][0].get("setup_s")
