"""ETC1S encoder: the palette core: the segment's blocks cut and uploaded, `palette_core` (K4-K6 and the segment sum) and its palettes fetched to the host.

Read from the program's `etc1s.core_s` spans (`uvbench.program_spans`):
their time summed per `encode_ktx2_etc1s` call, the mean over the calls
wholly inside the traced stretch, in ms. None where the program records
no span."""

from uvbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "etc1s.core_s")
