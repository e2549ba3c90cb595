"""ETC1S encoder: the delta-aware stage: `delta_bias_assignments` and each `rate_sweep_assignments` (K7), a frame at a time, each fetched to the host.

Read from the program's `etc1s.delta_s` spans (`uvbench.program_spans`):
their time summed per `encode_ktx2_etc1s` call, the mean over the calls
wholly inside the traced stretch, in ms. None where the program records
no span."""

from uvbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "etc1s.delta_s")
