"""Distribution substrate of the port: the halo exchange of distributed
stencils over ``torch.distributed`` (``halo``).

The reference package's ``repro.parallel``; its logical-axis sharding rules
(``sharding.py``) and gradient compression belong to the training path and
are not ported yet.
"""

from .halo import (
    HaloExchange,
    exchange_halo_2d,
    gather_blocks,
    message_counts,
    request_exchange,
    reset_message_counts,
    shard_blocks,
)

__all__ = [
    "HaloExchange",
    "exchange_halo_2d",
    "gather_blocks",
    "message_counts",
    "request_exchange",
    "reset_message_counts",
    "shard_blocks",
]
