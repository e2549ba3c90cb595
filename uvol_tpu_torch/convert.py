"""Carry a codec or a fitted trajectory group across from the JAX package.

The system has no learned weights: what a JAX codec holds is its
configuration. `from_jax_codec` reads it by duck typing (so this module
needs no `jax` import) and builds the port's codec with the same
settings; arrays, where any cross, cross as numpy
(`from_jax_trajectory_group`: a fitted group's coefficients).
"""

from __future__ import annotations

from typing import Union

import numpy as np

from uvol_tpu_torch._device import DeviceLike
from uvol_tpu_torch.models.pointcloud import PointCloudSequenceCodec
from uvol_tpu_torch.models.sequence import (
    GeometrySequenceCodec,
    TextureSequenceCodec,
)
from uvol_tpu_torch.models.trajectory import TrajectoryGroup
from uvol_tpu_torch.parallel.mesh import FRAME_AXIS, axis_size


def _frames_axis(jax_mesh) -> int:
    """The size of a JAX mesh's `frames` axis (`mesh.shape` maps axis
    names to sizes); 1 for no mesh."""
    if jax_mesh is None:
        return 1
    shape = getattr(jax_mesh, "shape", None)
    if not hasattr(shape, "get") or FRAME_AXIS not in shape:
        raise TypeError(f"not a mesh with a {FRAME_AXIS!r} axis: {type(jax_mesh).__name__}")
    return int(shape[FRAME_AXIS])


def from_jax_codec(
    codec, *, device: DeviceLike = None, mesh=None
) -> Union[GeometrySequenceCodec, TextureSequenceCodec, PointCloudSequenceCodec]:
    """A `uvol_tpu.models.sequence` codec or a
    `uvol_tpu.models.pointcloud.PointCloudSequenceCodec` → the equivalent
    port codec.

    A JAX mesh cannot become a process group, so a meshed codec takes the
    port's mesh (`parallel.mesh.make_mesh`) as `mesh`: the sizes of the two
    meshes' `frames` axes must be equal (no mesh counts as 1), or this
    raises ValueError naming both. The point-cloud codec has no mesh and
    takes none. Raises TypeError for anything that is not such a codec."""
    if hasattr(codec, "position_bits") and not hasattr(codec, "uv_bits"):
        if mesh is not None:
            raise ValueError("the point-cloud codec runs on one device: it takes no mesh")
        return PointCloudSequenceCodec(int(codec.position_bits), device=device)
    want = _frames_axis(getattr(codec, "mesh", None))
    got = axis_size(mesh) if mesh is not None else 1
    if want != got:
        raise ValueError(f"the JAX codec's mesh has {want} devices on its {FRAME_AXIS!r} axis, "
                         f"the port's mesh {got} ranks")
    if hasattr(codec, "position_bits") and hasattr(codec, "uv_bits"):
        return GeometrySequenceCodec(
            int(codec.position_bits), int(codec.uv_bits), device=device, mesh=mesh
        )
    if hasattr(codec, "sequence_size") and hasattr(codec, "supercompression"):
        return TextureSequenceCodec(
            int(codec.sequence_size), str(codec.supercompression), device=device, mesh=mesh
        )
    raise TypeError(f"not a sequence codec: {type(codec).__name__}")


def from_jax_trajectory_group(group) -> TrajectoryGroup:
    """A fitted `uvol_tpu.models.trajectory.TrajectoryGroup` (numpy
    coefficients [degree + 1, N, 3], `frame_count`, `degree`) → the port's,
    the coefficients copied as float32."""
    for name in ("coefficients", "frame_count", "degree"):
        if not hasattr(group, name):
            raise TypeError(f"not a trajectory group (no {name!r}): {type(group).__name__}")
    return TrajectoryGroup(np.array(group.coefficients, np.float32), int(group.frame_count),
                           int(group.degree))
