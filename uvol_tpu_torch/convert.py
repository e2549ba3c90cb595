"""Carry a codec across from the JAX package.

The system has no learned weights: what a JAX codec holds is its
configuration. `from_jax_codec` reads it by duck typing (so this module
needs no `jax` import) and builds the port's codec with the same
settings; arrays, where any cross, cross as numpy.
"""

from __future__ import annotations

from typing import Union

from uvol_tpu_torch._device import DeviceLike
from uvol_tpu_torch.models.sequence import (
    GeometrySequenceCodec,
    TextureSequenceCodec,
)


def from_jax_codec(
    codec, *, device: DeviceLike = None
) -> Union[GeometrySequenceCodec, TextureSequenceCodec]:
    """A `uvol_tpu.models.sequence` codec → the equivalent port codec.

    Raises NotImplementedError for a codec with a `mesh` (multi-device is
    not ported yet) and TypeError for anything else."""
    if getattr(codec, "mesh", None) is not None:
        raise NotImplementedError(
            "codecs with a device mesh are not ported yet (ROADMAP.md)"
        )
    if hasattr(codec, "position_bits") and hasattr(codec, "uv_bits"):
        return GeometrySequenceCodec(
            int(codec.position_bits), int(codec.uv_bits), device=device
        )
    if hasattr(codec, "sequence_size") and hasattr(codec, "supercompression"):
        return TextureSequenceCodec(
            int(codec.sequence_size), str(codec.supercompression), device=device
        )
    raise TypeError(f"not a sequence codec: {type(codec).__name__}")
