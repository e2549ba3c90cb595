"""ETC1S encoder: the host emission of the segment's KTX2 bytes (`_emit_segment`).

Read from the program's `etc1s.emit_s` spans (`uvbench.program_spans`):
their time summed per `encode_ktx2_etc1s` call, the mean over the calls
wholly inside the traced stretch, in ms. None where the program records
no span."""

from uvbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "etc1s.emit_s")
