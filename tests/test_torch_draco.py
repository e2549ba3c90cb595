"""The port's copy of the Python Draco codec against the reference's, on the
CPU.

Every stream kind that leaves the native whole-frame decoder (the
standard edge coder, prediction-degree traversal with the constrained
multi-parallelogram, raw integer corrections, tagged symbols, a
sequential mesh, a kd-tree point cloud) and the default valence stream
are written by the reference's own encoders. The port's `decode_drc`
must return the reference's arrays, and the port's encoders the
reference's bytes, with the native library and with it refused: the
`path` fixture sets `UVT_DISABLE_NATIVE_DRACO=1` for the port and turns
the reference's loader off as tests/test_native_draco.py does.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import uvol_tpu.native as jnative
from uvol_tpu import encoder_cli as jcli
from uvol_tpu.codecs.draco import decoder as jdec
from uvol_tpu.codecs.draco import encoder as jenc
from uvol_tpu.codecs.draco import kdtree as jkd
from uvol_tpu.codecs.draco import sequential as jseqd
from uvol_tpu_torch import encoder_cli as tcli
from uvol_tpu_torch import native as tnative
from uvol_tpu_torch.codecs.draco import decoder as tdec
from uvol_tpu_torch.codecs.draco import encoder as tenc
from uvol_tpu_torch.codecs.draco import kdtree as tkd
from uvol_tpu_torch.codecs.draco import sequential as tseqd
from uvol_tpu_torch.codecs.draco.grid import grid_mesh

FIXTURES = Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(params=["native", "python"])
def path(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(jnative, "_draco_failed", True)
        monkeypatch.setattr(jnative, "_draco_lib", None)
        monkeypatch.setenv("UVT_DISABLE_NATIVE_DRACO", "1")
        assert tnative.get_draco_lib() is None
    else:
        monkeypatch.delenv("UVT_DISABLE_NATIVE_DRACO", raising=False)
        assert tnative.get_draco_lib() is not None  # g++ builds the port's library
    return request.param


def _mesh_attributes(enc, ny: int = 9, nx: int = 13, seed: int = 3):
    """A displaced grid with positions, texcoords and normals, as `enc`'s
    AttributeToEncode records; the texcoords seamed along one column."""
    pos, uv, nrm, faces = grid_mesh(ny, nx, seed)
    c2v = faces.reshape(-1)
    uv_c2v = c2v.copy()
    seam = (c2v % nx) == nx // 2
    uv_c2v[seam] = len(uv) + np.arange(seam.sum()) % ny  # extra texcoord values
    uv = np.concatenate([uv, uv[: ny] + np.float32(0.25)])
    K = enc.K
    return faces, [enc.AttributeToEncode(K.ATT_POSITION, pos, c2v, 11),
                   enc.AttributeToEncode(K.ATT_TEX_COORD, uv, uv_c2v, 10),
                   enc.AttributeToEncode(K.ATT_NORMAL, nrm, c2v, 8)]


def _cloud_attributes(enc, n: int = 700, seed: int = 5):
    r = np.random.default_rng(seed)
    centers = r.uniform(-1, 1, (6, 3))
    pts = (centers[r.integers(0, 6, n)] + r.normal(0, 0.02, (n, 3))).astype(np.float32)
    col = r.integers(0, 256, (n, 3)).astype(np.uint8)
    K = enc.K
    return [enc.AttributeToEncode(K.ATT_POSITION, pts, np.arange(n), 14),
            enc.AttributeToEncode(K.ATT_GENERIC, col, np.arange(n), integer=True)]


def _tagged_attributes(enc):
    """Positions, and an integer attribute of values up to 2^22: its
    symbols take the tagged scheme."""
    faces, atts = _mesh_attributes(enc)
    n = len(atts[0].values)
    wide = np.random.default_rng(7).integers(0, 1 << 22, (n, 1)).astype(np.int32)
    return faces, [atts[0], enc.AttributeToEncode(enc.K.ATT_GENERIC, wide,
                                                  faces.reshape(-1), integer=True)]


def _encode(kind: str, port: bool) -> bytes:
    """The stream of `kind` by the port's encoders (`port`) or the
    reference's."""
    enc, seq, kd = (tenc, tseqd, tkd) if port else (jenc, jseqd, jkd)
    if kind == "kdtree":
        return kd.encode_drc_point_cloud_kdtree(_cloud_attributes(enc))
    if kind == "point_cloud":
        return seq.encode_drc_point_cloud(_cloud_attributes(enc))
    if kind == "tagged":
        return enc.encode_drc(*_tagged_attributes(enc))
    faces, atts = _mesh_attributes(enc)
    if kind == "sequential":
        return seq.encode_drc_sequential(faces, atts)
    opts = {"valence": {}, "standard": {"traversal_encoding": "standard"},
            "prediction_degree": {"attribute_traversal": "prediction_degree",
                                  "position_prediction": "constrained_multi"},
            "raw_integers": {"integer_compression": False}}[kind]
    return enc.encode_drc(faces, atts, **opts)


KINDS = ["valence", "standard", "prediction_degree", "raw_integers", "tagged", "sequential",
         "point_cloud", "kdtree"]


def _assert_same_mesh(got, want) -> None:
    assert got.faces.dtype == want.faces.dtype
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.num_points == want.num_points
    np.testing.assert_array_equal(got._point_of_corner, want._point_of_corner)
    assert len(got.attributes) == len(want.attributes)
    for a, b in zip(got.attributes, want.attributes):
        assert (a.attribute_type, a.data_type, a.num_components, a.normalized,
                a.unique_id) == (b.attribute_type, b.data_type, b.num_components,
                                 b.normalized, b.unique_id)
        assert a.values.dtype == b.values.dtype
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(a.corner_to_value, b.corner_to_value)
        np.testing.assert_array_equal(got.point_attribute(a.attribute_type),
                                      want.point_attribute(b.attribute_type))


@pytest.mark.parametrize("kind", KINDS)
def test_decode_drc_matches_the_reference(path, kind):
    data = _encode(kind, port=False)
    _assert_same_mesh(tdec.decode_drc(data), jdec.decode_drc(data))


def test_decode_drc_of_the_standard_coder_fixture_matches_the_reference(path):
    data = (FIXTURES / "grid_std.drc").read_bytes()
    assert tnative.drc_decode_native(data) is None  # off the whole-frame path
    _assert_same_mesh(tdec.decode_drc(data), jdec.decode_drc(data))


def test_whole_frame_switch_holds_only_the_frame_codec(monkeypatch):
    """`UVT_DISABLE_NATIVE_FRAME=1` refuses the whole-frame decode and
    encode; the staged helpers still run, and the bytes do not change."""
    data = _encode("valence", port=False)
    assert tnative.drc_decode_native(data) is not None
    monkeypatch.setenv("UVT_DISABLE_NATIVE_FRAME", "1")
    assert tnative.drc_decode_native(data) is None
    assert tnative.get_draco_lib() is not None
    _assert_same_mesh(tdec.decode_drc(data), jdec.decode_drc(data))
    assert _encode("valence", port=True) == data


@pytest.mark.parametrize("kind", KINDS)
def test_encode_drc_writes_the_reference_bytes(path, kind):
    assert _encode(kind, port=True) == _encode(kind, port=False)


def test_srgb_decode_matches_the_reference():
    data = _encode("point_cloud", port=False)
    got = tdec.decode_drc(data, vertex_color_space="srgb")
    want = jdec.decode_drc(data, vertex_color_space="srgb")
    _assert_same_mesh(got, want)


# ---- the encoder CLI on the Python path --------------------------------------


def _grid_project(root: Path, ny: int = 20, nx: int = 30, frames: int = 3) -> str:
    """`frames` OBJ frames of an ny x nx grid with texcoords and normals,
    geometry only."""
    (root / "OBJ").mkdir(parents=True)
    for f in range(frames):
        pos, uv, nrm, faces = grid_mesh(ny, nx, 40 + f)
        lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in pos]
        lines += [f"vt {u:.6f} {v:.6f}" for u, v in uv]
        lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in nrm]
        lines += ["f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in tri) for tri in faces]
        (root / "OBJ" / f"{f:05d}.obj").write_text("\n".join(lines) + "\n")
    cfg = {"name": "dracopy", "OBJFilesPath": f"{root}/OBJ/[#####].obj", "ImagesPath": None,
           "OutputDirectory": f"{root}/output", "GEOMETRY_CODEC": "draco",
           "ENCODE_WORKERS": 1}
    (root / "config.json").write_text(json.dumps(cfg))
    return str(root / "config.json")


def test_cli_on_the_python_draco_path_writes_the_reference_files(tmp_path, monkeypatch):
    monkeypatch.setenv("UVT_PLATFORM", "cpu")
    monkeypatch.setenv("UVT_DISABLE_NATIVE_DRACO", "1")
    monkeypatch.setattr(jnative, "_draco_failed", True)
    monkeypatch.setattr(jnative, "_draco_lib", None)
    calls = []
    encode = tenc.encode_drc
    monkeypatch.setattr(tenc, "encode_drc", lambda *a, **k: calls.append(1) or encode(*a, **k))
    assert jcli.main([_grid_project(tmp_path / "ref")]) == 0
    assert tcli.main([_grid_project(tmp_path / "port")]) == 0
    assert len(calls) == 3
    trees = [{str(p.relative_to(root)): p.read_bytes()
              for p in sorted(root.rglob("*")) if p.is_file()}
             for root in (tmp_path / "ref" / "output", tmp_path / "port" / "output")]
    assert sorted(trees[1]) == sorted(trees[0])
    assert sum(n.endswith(".drc") for n in trees[1]) == 3
    for name, blob in trees[0].items():
        assert trees[1][name] == blob, name
