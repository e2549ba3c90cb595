"""The port's slice as a whole against the JAX package, on the CPU.

`uvol_tpu_torch.entry` must reproduce `__graft_entry__.entry` exactly on
the same inputs; the port must run on a machine with no JAX at all; and
its kernel build must fail loudly, naming nvcc, where there is none.
"""

import os
import re
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
#: the JAX package's jax-free host modules that the port may import
HOST_MODULES = {
    "uvol_tpu.codecs.symbol_coding",
    "uvol_tpu.codecs.buffer",
    "uvol_tpu.codecs.basis.etc1s_encode",  # its host functions only
    "uvol_tpu.codecs.basis.huffman",
    "uvol_tpu.codecs.basis.transcoder",
    "uvol_tpu.containers.ktx2",
    "uvol_tpu.native",
    "uvol_tpu.native.zstd",
}


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
    """A subprocess where `import jax` fails imports the port and runs a
    2-frame geometry and texture round trip and a 1-frame ETC1S encode
    on the CPU (so no lazy `import jax` of the JAX package's host code
    is reached)."""
    script = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None  # any import of jax now raises
        import numpy as np
        import uvol_tpu_torch
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
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                       if sys.modules[m] is not None)
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_port_sources_never_import_jax():
    files = list((REPO / "uvol_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (f, line)


def test_port_imports_only_jax_free_host_modules():
    """The package reaches `uvol_tpu` only through its jax-free host
    modules; `chip_smoke.py` reaches it only through the port."""
    files = list((REPO / "uvol_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    seen = set()
    for f in files:
        for line in f.read_text().splitlines():
            m = re.match(r"\s*(?:from|import)\s+(uvol_tpu(?:\.[\w.]+)?)\b", line)
            if m:
                assert f.name != "chip_smoke.py", line
                assert m.group(1) in HOST_MODULES, (f, line)
                seen.add(m.group(1))
    assert "uvol_tpu.codecs.symbol_coding" in seen  # the scan finds imports


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
