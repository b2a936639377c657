"""Redis interop tier: wire client, connection pool, topology routers, blob
codecs, the embedded RESP server and the durability flush / import
(counterpart of `redisson_tpu.interop`).

The reference delegates durability entirely to the Redis server (SURVEY.md
§5 "Checkpoint/resume: none client-side"). In the port the roles invert:
sketches live on the card and this package is the boundary that flushes
them to / imports them from a real Redis — plus local snapshot files when
no server is around (see redisson_tpu_torch.checkpoint). In the
passthrough mode (`backend_redis`, `bloom_redis`, `coordination_redis`)
the server executes every op and the client holds no state.
"""

from redisson_tpu_torch.interop import hyll  # noqa: F401
