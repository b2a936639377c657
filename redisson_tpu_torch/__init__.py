"""redisson_tpu_torch: the PyTorch / CUDA port of redisson_tpu.

The single-device sketch engine on an NVIDIA card: HyperLogLog (PFADD /
PFCOUNT / PFMERGE), RBitSet (SETBIT, BITCOUNT, BITOP, ...) and
RBloomFilter, with hand-written CUDA kernels (`csrc/`) for the segmented
insert and segment-OR, the stacked merge, BITCOUNT and BITOP. Entry point:
`redisson_tpu_torch.client.RedissonTorch.create(Config().use_cuda())`.
Pass `device="cpu"` to run the same engine on the CPU.

The package imports neither JAX nor any `redisson_tpu` module.
"""
