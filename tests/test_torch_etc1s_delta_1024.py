"""The whole delta path of the port's ETC1S encode at 1024/1024 (RGBA)
against the JAX package, on the CPU: the `.ktx2` bytes must be the
reference's. The reference's palette build takes its Pallas path in
interpret mode, as in tests/test_torch_etc1s_delta.py, which holds the
other cases of this test at 512/512 and the delta stage's passes.
"""

import pytest

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from torch_etc1s_cases import hold_delta_encode, take_jax_kernel_path


@pytest.fixture(scope="module")
def jax_kernel_path():
    """The JAX package's `build_palettes` on its Pallas path, in interpret
    mode, for the module; its quad pass gets writable grids
    (`take_jax_kernel_path`)."""
    with pytest.MonkeyPatch.context() as mp:
        take_jax_kernel_path(mp, writable_quads=True)
        yield


@pytest.mark.parametrize("quads", [False, True])
@pytest.mark.parametrize("kind", ["rgba_1024"])
def test_encode_delta_path_matches_jax_kernel_path(jax_kernel_path, kind, quads):
    """RGBA at 1024/1024 (alpha doubles the blocks to 1,024), with the
    defaults' delta window and lambda: the bytes equal the JAX package's
    and decode at >= 24 dB (`hold_delta_encode`)."""
    hold_delta_encode(kind, quads)
