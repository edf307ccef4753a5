"""zero_comm_ms.sp4: device ms a step of the NCCL kernels launched inside
rank 0's `parallel.zero_gather` and `parallel.zero_scatter` spans (ZeRO-3's
weight all-gathers and gradient reduce-scatters)."""

from port_bench import sp_readers


def read(rec):
    return sp_readers.span_ms(rec, "parallel.zero_gather", "parallel.zero_scatter",
                              nccl_only=True)
