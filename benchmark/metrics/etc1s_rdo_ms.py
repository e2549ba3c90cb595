"""ETC1S encoder: the RDO refine (`_rdo_refine`, a frame at a time, fetched to the host at its end).

Read from the program's `etc1s.rdo_s` spans (`uvbench.program_spans`):
their time summed per `encode_ktx2_etc1s` call, the mean over the calls
wholly inside the traced stretch, in ms. None where the program records
no span."""

from uvbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "etc1s.rdo_s")
