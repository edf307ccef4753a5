"""Parallelism over `torch.distributed`: process bootstrap, the (dp, sp,
su) device mesh and its ZeRO-3 sharding rules, and sequence parallelism
(ring, zigzag ring, Ulysses and their 2D hybrid)."""
