"""The RESP network front-end, engine-side L0 (counterpart of
`redisson_tpu.wire`).

``proto`` is the single RESP frame codec (the port's C++ encode / parse
re-exported plus the reply renderers); ``commands`` maps RESP command
frames onto engine ops; ``server`` hosts the asyncio WireServer and the
cluster frontend that puts one server in front of every shard.
"""

from redisson_tpu_torch.wire import proto
from redisson_tpu_torch.wire.commands import (ENGINE_COMMANDS,
                                              INLINE_COMMANDS, EngineCall,
                                              WireCommandError, build)
from redisson_tpu_torch.wire.server import (ClusterWireFrontend,
                                            ShardWireContext, WireServer)

__all__ = [
    "proto", "EngineCall", "WireCommandError", "build",
    "ENGINE_COMMANDS", "INLINE_COMMANDS",
    "WireServer", "ClusterWireFrontend", "ShardWireContext",
]
