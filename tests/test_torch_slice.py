"""The port's slice as a whole against the JAX package, on the CPU.

`uvol_tpu_torch.entry` must reproduce `__graft_entry__.entry` exactly on
the same inputs; the port must run on a machine with neither JAX nor the
JAX package; and its kernel build must fail loudly, naming nvcc, where
there is none.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from uvol_tpu_torch import _build
from uvol_tpu_torch.entry import entry, example_inputs
from uvol_tpu_torch.utils.timing import device_time_ms

REPO = Path(__file__).resolve().parents[1]


def test_entry_matches_jax_entry():
    jfwd, jargs = __graft_entry__.entry()
    ref = jax.tree.map(np.asarray, jax.jit(jfwd)(*jargs))
    # identical example inputs, drawn from the same default_rng(0)
    for a, b in zip(example_inputs(), jargs):
        np.testing.assert_array_equal(a, np.asarray(b))
    fwd, args = entry("cpu")
    out = fwd(*args)
    assert set(out) == set(ref)
    for k, v in out.items():
        got = v.numpy()
        if v.dtype == torch.int32 and ref[k].dtype == np.uint32:
            got = got.view(np.uint32)  # symbols/words: uint32 bit patterns
        assert got.shape == ref[k].shape, k
        np.testing.assert_array_equal(got, ref[k], err_msg=k)


def test_port_runs_without_jax(tmp_path):
    """A subprocess whose import system refuses `jax` and the JAX package
    (`uvol_tpu`) imports every module of the port and runs a 2-frame
    geometry and texture round trip, a 1-frame ETC1S encode and a 2-frame
    `.drc` decode of tests/fixtures/grid.drc on the CPU, so no lazy
    import of either is reached."""
    script = textwrap.dedent(
        """
        import importlib, importlib.abc, pkgutil, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "uvol_tpu"):
                    raise ImportError(f"refused: {name}")
                return None

        sys.meta_path.insert(0, Refuse())
        import numpy as np
        import uvol_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(uvol_tpu_torch.__path__,
                                                       "uvol_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        from uvol_tpu_torch.models.sequence import (
            GeometryFrameSet, GeometrySequenceCodec, TextureSequenceCodec, read_ktx2)
        r = np.random.default_rng(0)
        pos = r.normal(size=(2, 300, 3)).astype(np.float32)
        uv = r.uniform(size=(2, 300, 2)).astype(np.float32)
        faces = [r.integers(0, 300, (100, 3)).astype(np.int32) for _ in range(2)]
        geo = GeometrySequenceCodec(device="cpu")
        dec = geo.decode(geo.encode(GeometryFrameSet(pos, uv, np.array([300, 250]), faces)))
        step = (pos[0].max(0) - pos[0].min(0)).max() / 2047
        assert np.abs(dec.positions[0] - pos[0]).max() <= step
        assert all((a == b).all() for a, b in zip(dec.faces, faces))
        tex = r.integers(0, 256, (2, 16, 16, 3)).astype(np.uint8)
        tc = TextureSequenceCodec(sequence_size=2, supercompression="zstd", device="cpu")
        out = tc.decode_segment(read_ktx2(tc.encode_segment(tex)))
        assert out.shape == tex.shape and out.dtype == np.uint8
        from uvol_tpu_torch.codecs.basis.etc1s_encode import (
            encode_ktx2_etc1s, read_ktx2 as read_basis, transcode_ktx2_etc1s)
        blob = encode_ktx2_etc1s(tex[:1], num_endpoints=8, num_selectors=8, device="cpu")
        assert transcode_ktx2_etc1s(read_basis(blob)).shape[:3] == (1, 16, 16)
        from uvol_tpu_torch.models.drc_device import decode_drc_batch
        drc = open(sys.argv[1], "rb").read()
        batch = decode_drc_batch([drc, drc], device="cpu", as_numpy=True)
        assert batch.values[0].shape == (2, 4096, 3) and batch.counts[0].tolist() == [72, 72]
        assert np.isfinite(batch.values[1]).all() and len(batch.faces[1]) == 112
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "uvol_tpu")]
        assert not loaded, loaded
        print(len(names), "modules ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", script, str(REPO / "tests" / "fixtures" / "grid.drc")],
        cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("modules ok")
    assert int(proc.stdout.split()[-3]) >= 20  # the walk found the package


def _imported_modules(path: Path):
    """Every module name an `import` or `from ... import` in the file
    names (relative imports excluded)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_never_import_jax():
    files = list((REPO / "uvol_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (f, line)


def test_port_imports_only_jax_free_host_modules():
    """No module of the port and no line of `chip_smoke.py` imports the
    JAX package or `jax`, at any depth of the syntax tree (function-level
    imports included); the scan does find the port's own imports."""
    files = list((REPO / "uvol_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    seen = set()
    for f in files:
        for name in _imported_modules(f):
            top = name.split(".")[0]
            assert top not in ("uvol_tpu", "jax"), (f, name)
            seen.add(name)
    assert "uvol_tpu_torch.codecs.symbol_coding" in seen
    assert "uvol_tpu_torch.native" in seen


def test_device_time_ms_sums_device_events_only():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, kind, us):
        return SimpleNamespace(name=name, device_type=kind,
                               time_range=SimpleNamespace(elapsed_us=lambda: us))

    prof = SimpleNamespace(events=lambda: [
        ev("k", cuda, 1500.0), ev("k", cuda, 500.0), ev("Memcpy HtoD", cuda, 250.0),
        ev("aten::copy_", cpu, 9000.0),
    ])
    assert device_time_ms(prof) == {"k": 2.0, "Memcpy HtoD": 0.25}


def test_build_without_nvcc_names_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_build_library_name_tracks_sources(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text("// one\n")
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR
    (tmp_path / "a.cu").write_text("// two\n")
    assert _build.library_path() != first
