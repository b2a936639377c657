"""Multi-device distribution (counterpart of `redisson_tpu.parallel`). So
far only `topology.py`, the failure-detection poller the cluster tier and
`RedissonTorch.get_topology_manager` use; the mesh, the sharded banks and
the pod backend wait for ROADMAP Queue 1 item 7 (`parallel/` via
`torch.distributed`)."""
