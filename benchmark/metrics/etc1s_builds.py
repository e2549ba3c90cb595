"""ETC1S encoder: the palette builds a segment takes on the lambda ladder
of the quality floor (1 to 4 at the defaults).

Read from the program's `etc1s.build_s` spans (`uvbench.program_spans`):
their number per `encode_ktx2_etc1s` call, the mean over the calls wholly
inside the traced stretch. None where the program records no span."""

from uvbench import program_spans


def read(run):
    return program_spans.mean_count(run, "etc1s.build_s")
