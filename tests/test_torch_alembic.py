"""The port's Alembic input (`uvol_tpu_torch.io.ogawa`, `io.alembic` and
the encoder CLI's `ABCFilePath`) against the JAX package's, on the CPU.

The writers must emit the reference's bytes, the readers must give the
reference's arrays on either package's archive, and the encoder CLI
given an `ABCFilePath` project must write the reference CLI's files byte
for byte: the extracted OBJs, the `.drc` frames, the `.ktx2` segments,
the resume indexes and the manifest. The samples are the reference
test's wavy grid (tests/test_alembic.py), its heights drawn from a seed.
"""

import functools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu import encoder_cli as jcli
from uvol_tpu.codecs.basis import etc1s_encode as jenc
from uvol_tpu.io import alembic as jabc
from uvol_tpu.io import ogawa as jogawa
from uvol_tpu.models import sequence as jseq
from uvol_tpu_torch import encoder_cli as tcli
from uvol_tpu_torch.io import alembic as tabc
from uvol_tpu_torch.io import ogawa as togawa


def _samples(mod, n_frames=3, nx=5, ny=4, uvs=True, quads=False):
    """`n_frames` PolyMeshSamples of `mod` (each package has its class)."""
    r = np.random.default_rng(3)
    xx, yy = np.mgrid[0:nx, 0:ny].astype(np.float32)
    idx = lambda i, j: i * ny + j  # noqa: E731
    faces = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a, b, c, d = idx(i, j), idx(i + 1, j), idx(i + 1, j + 1), idx(i, j + 1)
            faces += [[a, b, c], [a, c, d]]
    out = []
    for f in range(n_frames):
        z = np.sin(xx.ravel() + 0.3 * f) + r.normal(size=nx * ny).astype(np.float32) * 0.01
        pos = np.stack([xx.ravel(), yy.ravel(), z], -1).astype(np.float32)
        uv = (np.stack([xx.ravel() / nx, yy.ravel() / ny], -1).astype(np.float32)
              if uvs else None)
        out.append(mod.PolyMeshSample(pos, np.asarray(faces, np.int32), uv))
    return out


def _same_sample(a, b):
    for name in ("positions", "faces", "uvs"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_ogawa_bytes_and_reads_match():
    spec = lambda m: m.GroupSpec([  # noqa: E731
        b"hello", m.GroupSpec([b"", b"nested", m.GroupSpec()]), b"\x00" * 1000])
    blob = togawa.write_ogawa(spec(togawa))
    assert blob == jogawa.write_ogawa(spec(jogawa))
    t, j = togawa.OgawaReader(blob).root, jogawa.OgawaReader(blob).root
    assert len(t) == len(j) == 3
    for i in (0, 2):
        assert t.is_data(i) and t.data(i).read() == j.data(i).read()
    sub_t, sub_j = t.group(1), j.group(1)
    assert [sub_t.data(i).read() for i in (0, 1)] == [sub_j.data(i).read() for i in (0, 1)]
    assert len(sub_t.group(2)) == len(sub_j.group(2)) == 0


@pytest.mark.parametrize("uvs", [True, False])
@pytest.mark.parametrize("fps", [30.0, 24.0])
def test_write_abc_polymesh_bytes_match(uvs, fps):
    blob = tabc.write_abc_polymesh(_samples(tabc, uvs=uvs), fps=fps, metadata={"take": "7"})
    assert blob == jabc.write_abc_polymesh(_samples(jabc, uvs=uvs), fps=fps,
                                           metadata={"take": "7"})


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("uvs", [True, False])
def test_read_abc_and_samples_match(writer, uvs):
    """`read_abc` and `AbcPolyMesh.sample` give the reference's arrays, on
    the port's archive and on the reference's."""
    mod = tabc if writer == "port" else jabc
    blob = mod.write_abc_polymesh(_samples(mod, n_frames=4, uvs=uvs), fps=24.0)
    ta, ja = tabc.read_abc(blob), jabc.read_abc(blob)
    assert ta.fps == ja.fps == 24.0
    assert ta.metadata == ja.metadata and ta.time_samplings == ja.time_samplings
    tm, jm = tabc.AbcPolyMesh(ta), jabc.AbcPolyMesh(ja)
    assert tm.num_samples == jm.num_samples == 4
    for i in range(4):
        _same_sample(tm.sample(i), jm.sample(i))


def test_fan_triangulation_and_refusals_match():
    idx, counts = np.arange(9), np.array([4, 5])
    np.testing.assert_array_equal(tabc._triangulate(idx, counts),
                                  jabc._triangulate(idx, counts))
    for mod in (tabc, jabc):
        with pytest.raises(ValueError, match="fewer than 3"):
            mod._triangulate(np.array([0, 1]), np.array([2]))
    foreign = jogawa.write_ogawa(jogawa.GroupSpec(
        [b"AbcCoreOgawa stuff", jogawa.GroupSpec(), b"", b""]))
    messages = []
    for mod in (tabc, jabc):
        with pytest.raises(ValueError, match="foreign") as e:
            mod.read_abc(foreign)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


# ---- the encoder CLI's ABCFilePath ------------------------------------------


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """The reference's ETC1S palette build on its Pallas path in interpret
    mode, as tests/test_torch_cli.py sets it up."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jenc, "_palette_core_fn",
                        functools.partial(jenc._palette_core_fn, pallas_interpret=True))
    monkeypatch.setattr(jenc, "_PALETTE_JIT_CACHE", {})
    monkeypatch.setattr(jseq, "_pallas_available", lambda: False)


def _abc_project(root: Path, uvs: bool, images: bool) -> str:
    root.mkdir(parents=True)
    (root / "anim.abc").write_bytes(jabc.write_abc_polymesh(_samples(jabc, uvs=uvs), fps=30.0))
    cfg = {"name": "abctest", "ABCFilePath": str(root / "anim.abc"),
           "OutputDirectory": str(root / "output"), "ENCODE_WORKERS": 1,
           "KTX2_BATCH_SIZE": 3, "ETC1S_ENDPOINTS": 16, "ETC1S_SELECTORS": 16,
           "ImagesPath": None}
    if images:
        (root / "images").mkdir()
        r = np.random.default_rng(0)
        for f in range(3):
            img = (r.uniform(0, 1, (32, 32, 3)) * 60 + 80).astype(np.uint8)
            Image.fromarray(img).save(root / "images" / f"{f:05d}.png")
        cfg["ImagesPath"] = str(root / "images" / "[#####].png")
    (root / "config.json").write_text(json.dumps(cfg))
    return str(root / "config.json")


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("uvs,images", [(True, True), (False, False)])
def test_cli_abc_project_writes_the_reference_files(tmp_path, monkeypatch, jax_kernel_path,
                                                   uvs, images):
    monkeypatch.setenv("UVT_PLATFORM", "cpu")
    ref = _abc_project(tmp_path / "ref", uvs, images)
    port = _abc_project(tmp_path / "port", uvs, images)
    assert jcli.main([ref]) == 0
    assert tcli.main([port]) == 0
    got, want = _tree(tmp_path / "port" / "output"), _tree(tmp_path / "ref" / "output")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert [n for n in got if n.startswith("OBJ/")] == [f"OBJ/0000{i}.obj" for i in range(3)]
    assert sum(n.endswith(".drc") for n in got) == 3
    assert sum(n.endswith(".ktx2") for n in got) == (1 if images else 0)
    assert (b"vt " in got["OBJ/00000.obj"]) == uvs
    # a rerun that changes nothing leaves every file alone, the OBJs included
    mtimes = {p: p.stat().st_mtime_ns for p in (tmp_path / "port" / "output").rglob("*")}
    assert tcli.main([port]) == 0
    assert mtimes == {p: p.stat().st_mtime_ns
                      for p in (tmp_path / "port" / "output").rglob("*")}
