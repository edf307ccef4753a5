"""ring_exposed_ms.sp4: device ms a step of the NCCL send / receive
kernels launched inside rank 0's `parallel.ring` spans during which no
compute kernel ran (the rotations the ring does not hide)."""

from port_bench import sp_readers


def read(rec):
    return sp_readers.exposed_ms(rec, "parallel.ring")
