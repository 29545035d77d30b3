"""Time a step of a step distributed over cards: read as ``step_ms`` (rank
0, between barriers that every rank passes), and kept apart from it so that
its own spread sets its own bound."""

from bench.metrics import step_ms


def read(ctx):
    return step_ms.read(ctx)
