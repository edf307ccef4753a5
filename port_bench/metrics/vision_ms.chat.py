"""vision_ms.chat: Device ms per media encode: the kernels launched inside
the engine's encode_media (SigLIP W8A8 and the projector)."""

from port_bench import readers


def read(rec):
    return readers.media_ms(rec)
