"""Distribution substrate of the port: logical-axis sharding rules over
DTensor (``sharding``) and the halo exchange of distributed stencils over
``torch.distributed`` (``halo``).

The reference package's ``repro.parallel``; gradient compression is
``repro_torch.runtime.compression``.
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
from .sharding import (
    LogicalAxisRules,
    axis_rules,
    current_rules,
    logical_sharding,
    logical_spec,
    with_logical_constraint,
)

__all__ = [
    "HaloExchange",
    "LogicalAxisRules",
    "axis_rules",
    "current_rules",
    "exchange_halo_2d",
    "gather_blocks",
    "logical_sharding",
    "logical_spec",
    "message_counts",
    "request_exchange",
    "reset_message_counts",
    "shard_blocks",
    "with_logical_constraint",
]
