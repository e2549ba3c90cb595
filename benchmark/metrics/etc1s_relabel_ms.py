"""ETC1S encoder: the endpoint palette relabels (`reorder_endpoint_palette`, host), five a build at 512 entries or more, one on the ladder's last rung.

Read from the program's `etc1s.relabel_s` spans (`uvbench.program_spans`):
their time summed per `encode_ktx2_etc1s` call, the mean over the calls
wholly inside the traced stretch, in ms. None where the program records
no span."""

from uvbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "etc1s.relabel_s")
