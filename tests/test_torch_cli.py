"""The port's encoder CLI (`uvol_tpu_torch.encoder_cli`) against the
reference's (`uvol_tpu.encoder_cli`), on the CPU.

Both CLIs take the same config on the same tiny project (the reference
test's shape: 6 frames of a 5 x 4 grid, 32 x 32 PNGs, KTX2_BATCH_SIZE 3)
and must write the same files, byte for byte: the `.drc`/`.uvtg` frames,
the `.ktx2` segments, every `.content_hashes.json` and `<name>.uvol.json`.
The port runs with `UVT_PLATFORM=cpu`. The reference's ETC1S palette
build takes its Pallas path in interpret mode (`jax_kernel_path`, as in
tests/test_torch_etc1s.py): on the CPU its own rule takes an XLA
fallback with bf16 k-means dots, which the port does not follow. That
fixture fakes a TPU backend for the whole process, so it also stops the
reference's sequence codecs from picking their Pallas kernels without
interpret mode (`_pallas_available`). The reference's Draco encoder may
take its Python pipeline where its native build lost a race between test
workers; that pipeline writes the same bytes, so only bytes are compared.

The `.uvtg` case holds exact bytes: the project's position and UV
offsets are products that float32 holds exactly or that sit far from a
k + 0.5 rounding boundary, where the reference's XLA code may round
`x * inv + 0.5` once or twice (ROADMAP.md §3).
"""

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu import encoder_cli as jcli
from uvol_tpu.codecs.basis import etc1s_encode as jenc
from uvol_tpu.models import sequence as jseq
from uvol_tpu_torch import encoder_cli as tcli
from uvol_tpu_torch.codecs.basis import etc1s_encode as tenc

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """Makes the JAX package's `build_palettes` take its Pallas path, in
    interpret mode, on the CPU (its own rule picks it on a TPU only), and
    keeps its sequence codecs on their XLA path under the faked backend."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jenc, "_palette_core_fn",
                        functools.partial(jenc._palette_core_fn, pallas_interpret=True))
    monkeypatch.setattr(jenc, "_PALETTE_JIT_CACHE", {})
    monkeypatch.setattr(jseq, "_pallas_available", lambda: False)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("UVT_PLATFORM", "cpu")


def _make_assets(root: Path, n_frames: int = 6, tex: int = 32, **cfg_over) -> str:
    """The reference test's project (tests/test_encoder_cli.py), seeded."""
    (root / "OBJ").mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir(exist_ok=True)
    r = np.random.default_rng(0)
    nx, ny = 5, 4
    for f in range(n_frames):
        with open(root / "OBJ" / f"{f:05d}.obj", "w") as fh:
            for i in range(nx):
                for j in range(ny):
                    fh.write(f"v {i} {j} {0.1 * f}\n")
            for i in range(nx):
                for j in range(ny):
                    fh.write(f"vt {i/(nx-1):.3f} {j/(ny-1):.3f}\n")
            idx = lambda i, j: i * ny + j + 1  # noqa: E731
            for i in range(nx - 1):
                for j in range(ny - 1):
                    a, b, c, d = idx(i, j), idx(i + 1, j), idx(i + 1, j + 1), idx(i, j + 1)
                    fh.write(f"f {a}/{a} {b}/{b} {c}/{c}\n")
                    fh.write(f"f {a}/{a} {c}/{c} {d}/{d}\n")
        img = (r.uniform(0, 1, (tex, tex, 3)) * 60 + 80).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"{f:05d}.png")
    cfg = {
        "name": "clitest",
        "OBJFilesPath": f"{root}/OBJ/[#####].obj",
        "ImagesPath": f"{root}/images/[#####].png",
        "OutputDirectory": f"{root}/output",
        "KTX2_BATCH_SIZE": 3,
        "ETC1S_ENDPOINTS": 16,
        "ETC1S_SELECTORS": 16,
        "ENCODE_WORKERS": 1,
        **cfg_over,
    }
    path = root / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _tree(root: Path) -> dict:
    """Every file under root: relative path -> bytes."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _mtimes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.stat().st_mtime_ns for p in root.rglob("*")
            if p.is_file()}


def _both(tmp_path, tex: int = 32, **cfg):
    """The same project twice (ref/ and port/), each CLI on its own copy."""
    return (_make_assets(tmp_path / "ref", tex=tex, **cfg),
            _make_assets(tmp_path / "port", tex=tex, **cfg))


def _assert_same_outputs(tmp_path) -> dict:
    ref, port = _tree(tmp_path / "ref" / "output"), _tree(tmp_path / "port" / "output")
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert port[name] == ref[name], name
    return port


# ---- the outputs, byte for byte ---------------------------------------------


@pytest.mark.parametrize("geometry,texture,palette,tex", [
    ("draco", "etc1s", 16, 32),
    ("uvtg", "etc", 16, 32),
    ("draco", "etc1s,etc", 16, 32),
    # 512 endpoints or more: the delta-aware stage (the CLI's default is 1024);
    # 64 x 64 layers, so a segment's 768 blocks do not cap the palette below 512
    ("draco", "etc1s", 512, 64),
    # UASTC: the spec wire's host encode, alone and published beside ETC1S
    ("draco", "uastc", 16, 32),
    ("draco", "etc1s,uastc", 16, 32),
])
def test_cli_writes_the_reference_files(tmp_path, jax_kernel_path, on_cpu, monkeypatch,
                                        geometry, texture, palette, tex):
    sweeps = []
    sweep = tenc.rate_sweep_assignments
    monkeypatch.setattr(tenc, "rate_sweep_assignments",
                        lambda *a, **k: sweeps.append(1) or sweep(*a, **k))
    ref, port = _both(tmp_path, tex=tex, GEOMETRY_CODEC=geometry, TEXTURE_CODEC=texture,
                      ETC1S_ENDPOINTS=palette, ETC1S_SELECTORS=palette)
    assert jcli.main([ref]) == 0
    assert tcli.main([port]) == 0
    files = _assert_same_outputs(tmp_path)
    ext = {"draco": ".drc", "uvtg": ".uvtg"}[geometry]
    assert sum(n.endswith(ext) for n in files) == 6
    targets = {"etc1s": "etc1s-tpu", "etc": "etc-tpu", "uastc": "uastc-tpu"}
    for name in texture.split(","):
        seg_dir = f"texture_{targets[name]}_baseColor_default"
        assert sorted(n for n in files if n.startswith(seg_dir)) == [
            f"{seg_dir}/.content_hashes.json", f"{seg_dir}/00000.ktx2", f"{seg_dir}/00001.ktx2"]
    manifest = json.loads(files["clitest.uvol.json"])
    assert manifest["geometry"]["targets"][geometry]["frameCount"] == 6
    assert bool(sweeps) == (palette >= 512 and "etc1s" in texture)


def test_geometry_only_manifest_matches(tmp_path, jax_kernel_path, on_cpu):
    ref, port = _both(tmp_path, ImagesPath=None)
    assert jcli.main([ref]) == 0
    assert tcli.main([port]) == 0
    files = _assert_same_outputs(tmp_path)
    assert json.loads(files["clitest.uvol.json"])["texture"]["targets"] == {}


def test_create_template_matches(tmp_path, capsys):
    assert jcli.main(["create-template", str(tmp_path / "ref.json")]) == 0
    assert tcli.main(["create-template", str(tmp_path / "port.json")]) == 0
    assert (tmp_path / "ref.json").read_bytes() == (tmp_path / "port.json").read_bytes()
    assert tcli.TEMPLATE == jcli.TEMPLATE


def test_no_arguments_prints_usage_and_returns_2(capsys):
    assert tcli.main([]) == 2
    assert "python -m uvol_tpu_torch.encoder_cli" in capsys.readouterr().out


@pytest.mark.parametrize("bad", [
    {"name": ""},
    {"OBJFilesPath": None},
    {"GEOMETRY_FRAME_RATE": 30, "TEXTURE_FRAME_RATE": 20},
    {"name": None, "OBJFilesPath": "", "GEOMETRY_FRAME_RATE": 25, "TEXTURE_FRAME_RATE": 10},
    {"GEOMETRY_CODEC": "corto"},
    {"OBJFilesPath": "/nonexistent/[#####].obj"},
])
def test_config_errors_match(tmp_path, capsys, on_cpu, bad):
    """`check_all_fields` and the early exits: same messages, same codes."""
    ref, port = _both(tmp_path, **bad)
    codes = [jcli.main([ref])]
    ref_out = capsys.readouterr().out.replace(str(tmp_path / "ref"), "<root>")
    codes.append(tcli.main([port]))
    port_out = capsys.readouterr().out.replace(str(tmp_path / "port"), "<root>")
    assert codes == [1, 1]
    assert port_out == ref_out and port_out.startswith("error: ")
    cfg = tcli.load_config(port)
    assert tcli.check_all_fields(cfg) == jcli.check_all_fields(jcli.load_config(port))


def test_load_config_drops_comments_like_the_reference(tmp_path):
    path = tmp_path / "c.json"
    path.write_text('{\n  // a comment line\n  "name": "x",\n   // another\n'
                    '  "KTX2_BATCH_SIZE": 7\n}\n')
    assert tcli.load_config(str(path)) == jcli.load_config(str(path))
    assert tcli.load_config(str(path))["KTX2_BATCH_SIZE"] == 7


@pytest.mark.parametrize("parts", [
    (b"abc", "11/10/8"),
    (None, "x"),
    (np.arange(12, dtype=np.float32).reshape(3, 4), np.zeros(2, np.uint8)),
    ("3",),
])
def test_content_hash_matches(parts):
    assert tcli._content_hash(*parts) == jcli._content_hash(*parts)


# ---- resume --------------------------------------------------------------------


def test_second_run_writes_nothing(tmp_path, on_cpu):
    cfg = _make_assets(tmp_path, TEXTURE_CODEC="etc1s,etc")
    out = tmp_path / "output"
    assert tcli.main([cfg]) == 0
    before, files = _mtimes(out), _tree(out)
    assert tcli.main([cfg]) == 0
    assert _mtimes(out) == before  # indexes and manifest included
    assert _tree(out) == files


@pytest.mark.parametrize("changed", ["image", "obj"])
def test_a_changed_input_rewrites_only_its_output(tmp_path, jax_kernel_path, on_cpu, changed):
    ref, port = _both(tmp_path, TEXTURE_CODEC="etc1s,etc")
    assert jcli.main([ref]) == 0
    assert tcli.main([port]) == 0
    before = _mtimes(tmp_path / "port" / "output")
    for side in ("ref", "port"):  # frame 4: segment 00001 (frames 3-5), .drc 00004
        root = tmp_path / side
        if changed == "image":
            img = np.asarray(Image.open(root / "images" / "00004.png")).copy()
            img[:8, :8] = 255 - img[:8, :8]
            Image.fromarray(img).save(root / "images" / "00004.png")
        else:
            obj = root / "OBJ" / "00004.obj"
            obj.write_text(obj.read_text().replace("v 0 0 ", "v 0.25 0 ", 1))
    assert jcli.main([ref]) == 0
    assert tcli.main([port]) == 0
    after = _mtimes(tmp_path / "port" / "output")
    rewritten = {n for n in after if after[n] != before[n]
                 and not n.endswith((".content_hashes.json", ".uvol.json"))}
    want = ({"texture_etc1s-tpu_baseColor_default/00001.ktx2",
             "texture_etc-tpu_baseColor_default/00001.ktx2"}
            if changed == "image" else {"geometry_draco/00004.drc"})
    assert rewritten == want
    _assert_same_outputs(tmp_path)


# ---- inputs the port once refused, and where it runs ------------------------


@pytest.mark.parametrize("quality", [1, 2])
def test_uastc_quality_writes_the_reference_files(tmp_path, on_cpu, quality):
    """UASTC_QUALITY widens the spec encoder's candidate modes; 64 x 64
    layers with alpha in one segment take the RGBA mode set."""
    ref, port = _both(tmp_path, tex=64, TEXTURE_CODEC="uastc", UASTC_QUALITY=quality)
    for side in ("ref", "port"):  # one layer with alpha
        png = tmp_path / side / "images" / "00004.png"
        img = np.asarray(Image.open(png).convert("RGBA")).copy()
        img[..., 3] = np.arange(64, dtype=np.uint8)[None, :] * 4
        Image.fromarray(img).save(png)
    assert jcli.main([ref]) == 0
    assert tcli.main([port]) == 0
    files = _assert_same_outputs(tmp_path)
    assert "texture_uastc-tpu_baseColor_default/00001.ktx2" in files


@pytest.mark.parametrize("over", [
    {"ABCFilePath": "/data/take.abc"},
])
def test_unported_inputs_are_refused_before_any_output(tmp_path, capsys, on_cpu, over):
    """An input the port once refused now behaves as in the reference CLI
    (tests/test_torch_alembic.py encodes a real `ABCFilePath` project): a
    missing archive raises the same error after the same output, an empty
    output directory."""
    ref, port = _both(tmp_path, **over)
    errors, outs = [], []
    for main, cfg, side in ((jcli.main, ref, "ref"), (tcli.main, port, "port")):
        with pytest.raises(Exception) as e:
            main([cfg])
        errors.append((type(e.value), str(e.value)))
        outs.append(capsys.readouterr().out.replace(str(tmp_path / side), "<root>"))
    assert errors[0] == errors[1] and errors[0][0] is FileNotFoundError
    assert outs[0] == outs[1]
    assert _tree(tmp_path / "port" / "output") == _tree(tmp_path / "ref" / "output") == {}
    assert (tmp_path / "port" / "output").is_dir()


def test_cli_needs_the_card_unless_told_the_cpu(tmp_path, monkeypatch):
    cfg = _make_assets(tmp_path)
    monkeypatch.delenv("UVT_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main([cfg])
    assert not (tmp_path / "output").exists()
    monkeypatch.setenv("UVT_PLATFORM", "tpu")
    with pytest.raises((RuntimeError, ValueError), match="tpu"):
        tcli.main([cfg])


def test_draco_pool_writes_what_one_worker_writes(tmp_path, on_cpu):
    """ENCODE_WORKERS > 1: a pool of spawned workers, safe in this process
    with JAX's threads (a fork would copy them), gives the same bytes."""
    one = _make_assets(tmp_path / "one", ImagesPath=None)
    pool = _make_assets(tmp_path / "pool", ImagesPath=None, ENCODE_WORKERS=3)
    assert tcli.main([one]) == 0
    assert tcli.main([pool]) == 0
    assert _tree(tmp_path / "one" / "output") == _tree(tmp_path / "pool" / "output")


def test_draco_worker_imports_no_torch(tmp_path):
    """What a spawned Draco worker imports (the CLI module, meshio, the C
    encoder) loads no torch, so the workers touch nothing of CUDA."""
    cfg = _make_assets(tmp_path, ImagesPath=None)
    obj = json.loads(Path(cfg).read_text())["OBJFilesPath"].replace("[#####]", "00002")
    script = textwrap.dedent(
        """
        import sys
        from uvol_tpu_torch.encoder_cli import _encode_draco_frame
        blob = _encode_draco_frame((sys.argv[1], 11, 10, 8))
        assert blob[:5] == b"DRACO", blob[:5]
        assert "torch" not in sys.modules
        print("worker ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script, obj], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "worker ok"


def test_cli_runs_without_pillow_or_jax(tmp_path, on_cpu):
    """A subprocess that refuses `PIL`, `jax` and the JAX package encodes a
    PNG project through `python -m uvol_tpu_torch.encoder_cli`, its Draco
    frames in a pool of 3 workers, and writes what one in-process worker
    writes."""
    cfg = _make_assets(tmp_path / "sub", TEXTURE_CODEC="etc1s,etc", ENCODE_WORKERS=3)
    runner = textwrap.dedent(
        """
        import importlib.abc, runpy, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("PIL", "jax", "uvol_tpu"):
                    raise ImportError(f"refused: {name}")
                return None

        sys.meta_path.insert(0, Refuse())
        sys.argv = ["encoder_cli", sys.argv[1]]
        try:
            runpy.run_module("uvol_tpu_torch.encoder_cli", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        loaded = [m for m in sys.modules if m.split(".")[0] in ("PIL", "jax", "uvol_tpu")]
        assert not loaded, loaded
        print("cli ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), UVT_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", runner, cfg], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("cli ok")
    assert tcli.main([_make_assets(tmp_path / "one", TEXTURE_CODEC="etc1s,etc")]) == 0
    files = _tree(tmp_path / "sub" / "output")
    assert "geometry_draco/00005.drc" in files
    assert "texture_etc-tpu_baseColor_default/00001.ktx2" in files
    assert files == _tree(tmp_path / "one" / "output")
