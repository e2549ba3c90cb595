"""The decode-side witnesses against hand-made cases and the reference's
own frames."""

import numpy as np
import pytest

from uvbench import inputs, witness
from uvbench.ref.codecs.draco import constants as K
from uvbench.ref.codecs.draco.decoder import decode_drc
from uvbench.ref.codecs.draco.encoder import AttributeToEncode, encode_drc

SEED = 2**31 + 977


def _decoded(bits):
    """A frame of the grid through the reference's Draco encoder at `bits`
    position bits and its decoder: (mesh, positions, UVs, faces)."""
    pos, uvs, nrm, faces = inputs.grid_frames(SEED, 1, 9, 13)
    c2v = faces.reshape(-1)
    blob = encode_drc(faces, [AttributeToEncode(K.ATT_POSITION, pos[0], c2v, bits),
                              AttributeToEncode(K.ATT_TEX_COORD, uvs[0], c2v, 10),
                              AttributeToEncode(K.ATT_NORMAL, nrm[0], c2v, 8)])
    return decode_drc(blob), pos[0], uvs[0], faces


def test_step_and_error_in_steps():
    src = np.array([[0.0, 0.0], [2.0, 1.0]], np.float32)
    assert witness.step(src, 3) == pytest.approx(2.0 / 7)
    dec = src + np.array([[0.1, 0.0], [0.0, -0.05]], np.float32)
    assert witness.error_steps(dec, src, 3) == pytest.approx(0.1 / (2.0 / 7), rel=1e-6)


def test_faces_compare_by_oriented_triangle():
    f = np.array([[0, 1, 2], [2, 1, 3]])
    assert witness.same_faces(f[::-1], f)
    assert witness.same_faces(np.array([[1, 2, 0], [3, 2, 1]]), f)  # rotated
    assert not witness.same_faces(np.array([[0, 2, 1], [2, 1, 3]]), f)  # flipped


@pytest.mark.parametrize("bits,ok", [(11, True), (10, False)])
def test_drc_frame_within_half_a_step(bits, ok):
    """At the stated 11 bits every value lies within half a step; at 10 bits
    (the control's) past it."""
    m, pos, uvs, faces = _decoded(bits)
    err, same = witness.drc_frame(m.point_attribute(K.ATT_POSITION),
                                  m.point_attribute(K.ATT_TEX_COORD), m.faces, pos, uvs, faces,
                                  11, 10)
    assert same and (err <= 0.501) == ok


def test_drc_frame_matches_points_and_faces():
    m, pos, uvs, faces = _decoded(11)
    dpos, duv = m.point_attribute(K.ATT_POSITION), m.point_attribute(K.ATT_TEX_COORD)
    err, same = witness.drc_frame(dpos, duv, m.faces[:, ::-1], pos, uvs, faces, 11, 10)
    assert not same
    err, _ = witness.drc_frame(dpos + witness.step(pos, 11), duv, m.faces, pos, uvs, faces, 11, 10)
    assert err > 1.0
    err, _ = witness.drc_frame(dpos[:-1], duv[:-1], m.faces, pos, uvs, faces, 11, 10)
    assert err == float("inf")
