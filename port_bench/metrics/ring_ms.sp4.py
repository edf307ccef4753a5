"""ring_ms.sp4: device ms a step of the operations launched inside the
program's `parallel.ring` spans on rank 0 (the ring attention's forward,
its recomputation and its backward: K7-K9 and the K/V rotations)."""

from port_bench import sp_readers


def read(rec):
    return sp_readers.span_ms(rec, "parallel.ring")
