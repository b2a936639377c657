"""Multi-device distribution (counterpart of `redisson_tpu.parallel`): the
logical mesh (`mesh.py`), the sharded HLL bank (`sharded.py`), the sharded
bit arrays (`sharded_bits.py`), the pod backend (`backend_pod.py`) and the
failure-detection poller (`topology.py`) the cluster tier and
`RedissonTorch.get_topology_manager` use.

JAX's pod and mesh tiers are single-controller programs over one `Mesh` of
every device, their collectives inside `shard_map`. The port keeps that
shape with a single-process mesh of LOGICAL devices: each shard body runs
once per mesh entry over that entry's rows or cell range, and `pmax` /
`psum` become an explicit combine of the per-shard partials.
"""
