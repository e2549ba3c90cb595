"""ETC1S encoder: of the device's idle time inside the `encode_ktx2_etc1s`
calls wholly inside the traced stretch, the share (%) that lies under none
of the program's phase spans (core, rdo, relabel, delta, psnr, emit).

Read from the trace's busy intervals and the program's spans
(`uvbench.program_spans`). Low where the phase metrics account for the
host time the card waits on. None where the program records no span."""

from uvbench import program_spans


def read(run):
    return program_spans.idle_unattributed_pct(run)
