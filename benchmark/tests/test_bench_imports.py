"""The import check: top-level module names compared whole."""

import subprocess
import sys
from pathlib import Path

from uvbench.harness import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_compared_whole():
    mods = ["uvol_tpu_torch", "uvol_tpu_torch.models.sequence", "jaxtyping", "uvol_tpu_extra",
            "numpy", "flaxen"]
    assert forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "uvol_tpu", "uvol_tpu.codecs"]
    assert forbidden_modules(mods + bad) == sorted(bad)


def test_nothing_the_harness_loads_is_forbidden():
    """A fresh process imports the harness, every traffic kind, every reader,
    the reference and the program's modules the traffic uses: no JAX, no
    JAX package; the reference alone imports nothing of the program."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'benchmark')!r}]
import uvbench.ref.etc1, uvbench.ref.codecs.draco.encoder, uvbench.ref.codecs.draco.decoder
import uvbench.ref.codecs.basis.transcoder
assert not [m for m in sys.modules if m.split('.')[0] == 'uvol_tpu_torch'], 'the reference imports the program'
from uvbench import harness
bench = harness.load_benchmark()
for w in bench['workloads']:
    harness.load_cell(w['name'], bench)
import uvol_tpu_torch.models.sequence
import uvol_tpu_torch.codecs.basis.etc1s_encode, uvol_tpu_torch.codecs.draco.encoder
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_fails_without_a_card_or_the_program(tmp_path):
    """`run.py` exits non-zero with no result where there is no card (this
    machine), and in a directory holding only the benchmark."""
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                              "v2-etc1s-1k.encode", "--seed", "3000000000", "--seconds", "1",
                              "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert "correct" not in out.stdout
