"""The Draco pool's work, as `encoder_cli._encode_draco_frame` does it
without the OBJ parse: one frame's arrays to `.drc` bytes by the port's
`codecs.draco.encoder.encode_drc`. It runs in spawned worker processes
(numpy, the encoder and its C library; no torch), and returns the bytes
with the worker's own clock readings around the encode."""

from __future__ import annotations

import time


def encode_frame(args):
    pos, uv, nrm, faces, qp, qt, qn = args
    from uvol_tpu_torch.codecs.draco import constants as K
    from uvol_tpu_torch.codecs.draco.encoder import AttributeToEncode, encode_drc

    t0 = time.perf_counter()
    c2v = faces.reshape(-1)
    blob = encode_drc(faces, [AttributeToEncode(K.ATT_POSITION, pos, c2v, qp),
                              AttributeToEncode(K.ATT_TEX_COORD, uv, c2v, qt),
                              AttributeToEncode(K.ATT_NORMAL, nrm, c2v, qn)])
    return blob, t0, time.perf_counter()


def warm(_):
    """Import the encoder and load its library in a worker."""
    from uvol_tpu_torch import native
    from uvol_tpu_torch.codecs.draco import encoder  # noqa: F401

    return native.get_draco_lib() is not None
