"""The distributed step's copies a step: each traced call's ``exec_info``
``rank_timings`` seconds of the exchanges' packs and unpacks (stripes into
the send buffers, rims back from the receive buffers) and of the copies into
and out of the rank step's padded buffers, the largest over the ranks, in
ms; nothing where the record has no such timing."""

from .exchange_wait_ms import largest_over_ranks

KEYS = ("pack_seconds", "unpack_seconds", "pad_seconds", "release_seconds")


def read(ctx):
    return largest_over_ranks(ctx, KEYS)
