"""The ETC1S encoder port (uvol_tpu_torch) past one window of its kernels
(2,048 entries) against the JAX package, on the CPU.

K4's and K6's plain twins at 2,049 and 3,000 entries against the Pallas
kernels in interpret mode; and the whole `.ktx2` encode from the
reference's palette core at 2,049 and 3,000 endpoints and selectors, the
core taken from the reference's own encode of the same layer (its Pallas
path in interpret mode, as in tests/test_torch_etc1s.py, which holds the
cases at 256 and 1,024 entries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from torch_etc1s_cases import INTEN, _blocks, take_jax_kernel_path
from uvol_tpu.codecs.basis import etc1s_encode as jenc
from uvol_tpu.codecs.basis import etc1s_pallas as jpallas
from uvol_tpu_torch.codecs.basis import etc1s_cuda as kern
from uvol_tpu_torch.codecs.basis import etc1s_encode as tenc


@pytest.fixture
def jax_cores(monkeypatch):
    """Makes the JAX package's `build_palettes` take its Pallas path, in
    interpret mode, on the CPU (its own rule picks it on a TPU only), and
    returns the list that the outputs of each palette core it runs are
    appended to (numpy arrays: base5, inten, sel_cb, assign, sel_assign)."""
    cores = []
    take_jax_kernel_path(monkeypatch, on_core=cores.append)
    return cores


@pytest.mark.parametrize("e", [2049, 3000])
def test_assign_endpoints_twin_matches_pallas_above_the_window(e):
    """Wider than one window of the segment-sum and K6 kernels (2,048):
    K4 streams its endpoints in chunks and needs no change; its twin
    takes the Pallas kernel's first minimum over every entry."""
    n = 300
    r = np.random.default_rng(e)
    blocks = _blocks(n, 23)
    base = r.integers(0, 256, (e, 3)).astype(np.int32)
    inten = r.integers(0, 8, e).astype(np.int32)
    t = min(e, 2068) - 2048  # flat blocks whose best entry lies past 2,047
    blocks[10:10 + t] = r.integers(0, 256, (t, 1, 3))
    base[2048:2048 + t], inten[2048:2048 + t] = blocks[10:10 + t, 0], 0
    base[e - 1] = base[2048] if e > 2049 else base[e - 1]  # a tie past 2,048 (3,000)
    basef = base.astype(np.float32)
    me = (np.clip(basef[:, None, :] + INTEN[inten][:, :, None], 0, 255)
          - basef[:, None, :]).astype(np.float32)
    q = (2.0 * np.einsum("ec,ejc->ej", basef, me) + (me**2).sum(-1)).astype(np.float32)
    const = jpallas.endpoint_const_rows(jnp.asarray(basef), jnp.asarray(me), jnp.asarray(q), e)
    want = np.asarray(jpallas.assign_endpoints_pallas(
        jnp.asarray(blocks.reshape(n * 16, 3)), const, True))
    table = kern.endpoint_table(torch.from_numpy(base), torch.from_numpy(inten))
    got = kern.assign_endpoints(torch.from_numpy(blocks), table)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 2048).any()


@pytest.mark.parametrize("k", [2049, 3000])
def test_kmeans_iter_twin_matches_pallas_above_the_window(k):
    """K centroids past one window: the assignment (first minimum over
    every centroid) and the counts equal the Pallas kernel's, the sums
    agree to rounding (rtol 1e-6, as at 40 centroids)."""
    r = np.random.default_rng(k)
    n = 5000
    feats = (r.integers(0, 256, (n, 4)) + r.random((n, 4))).astype(np.float32)
    cb = feats[r.choice(n, k, replace=False)] + np.float32(0.25)
    cb[k - 2] = cb[0]  # a duplicate centroid: ties go to the first
    want = [np.asarray(x) for x in jpallas.kmeans_iter_pallas(
        jnp.asarray(feats), jnp.asarray(cb), True)]
    sums, counts, assign = [x.numpy() for x in kern.kmeans_iter(
        torch.from_numpy(feats), torch.from_numpy(cb))]
    np.testing.assert_array_equal(assign, want[2])
    np.testing.assert_array_equal(counts, want[1])
    assert counts[k - 2] == 0 and (assign >= 2048).any()
    np.testing.assert_allclose(sums, want[0], rtol=1e-6)


def _wide_layer(h: int, w: int) -> np.ndarray:
    """One random layer: 108 x 304 is 2,052 blocks and 200 x 240 3,000,
    the least segments a palette of 2,049 or 3,000 entries fits uncapped."""
    return np.random.default_rng(0).integers(0, 256, (1, h, w, 3)).astype(np.uint8)


def _encode_on_the_reference_core(monkeypatch, frames, kw, cores) -> bytes:
    """The port's encode with its palette core replaced by the reference's
    (Pallas, interpret mode): every stage after it (the RDO refine, the
    delta-aware stage, the lam ladder's rebuilds, the emission) is exact
    integer arithmetic, so the bytes must be the reference's. The core is
    the one the reference's own encode of `frames` ran (`cores`, from
    `jax_cores`): at these sizes, on these blocks, and the same at every
    rebuild of its lam ladder."""
    jax.effects_barrier()  # every recorded core has been handed over
    blocks = tenc._blocks_of(frames)
    core = [c.astype(np.int64) for c in cores[0]]
    assert len(core[0]) == min(kw["num_endpoints"], len(blocks))
    assert len(core[2]) == min(kw["num_selectors"], len(blocks)) and len(core[3]) == len(blocks)
    assert all(all(np.array_equal(a, b) for a, b in zip(c, cores[0])) for c in cores)
    used = []
    monkeypatch.setattr(tenc, "palette_core", lambda *a, **k: used.append(1) or tuple(
        torch.from_numpy(c.astype(np.int32)) for c in core))
    got = tenc.encode_ktx2_etc1s(frames, device="cpu", **kw)
    assert used
    return got


@pytest.mark.parametrize("arg", ["num_endpoints", "num_selectors"])
def test_build_palettes_names_the_entry_limit_at_its_top(arg, jax_cores, monkeypatch):
    """A palette of 2,049 entries, one past the kernels' window (refused
    until the kernels summed by windows): from the reference's palette
    core every later stage writes the reference's bytes (the endpoint
    case runs the delta-aware stage at E = 2,049). The core itself is held
    by its kernels' tests: K4 bit for bit and K6's sums to rtol 1e-6
    (`*_above_the_window`); its float sums (features, squares, the Lloyd
    centroids) agree with the reference's only to rounding, and one ulp
    there may move a cluster's 5-bit color, so the whole encode is not
    compared bit for bit."""
    frames = _wide_layer(108, 304)
    kw = {"num_endpoints": 64, "num_selectors": 64, arg: 2049}
    pal = tenc.build_palettes(frames, device="cpu", **kw)  # its own core: no refusal
    assert len(pal.color5 if arg == "num_endpoints" else pal.selectors) == 2049
    want = jenc.encode_ktx2_etc1s(frames, **kw)
    assert _encode_on_the_reference_core(monkeypatch, frames, kw, jax_cores) == want


def test_encode_at_3000_entries_matches_jax_kernel_path(jax_cores, monkeypatch):
    """3,000 endpoints and selectors on 3,000 blocks, as above: from the
    reference's core the encode (RDO, the delta-aware stage at E = 3,000,
    emission) writes the reference's bytes."""
    frames = _wide_layer(200, 240)
    kw = {"num_endpoints": 3000, "num_selectors": 3000}
    want = jenc.encode_ktx2_etc1s(frames, **kw)
    assert _encode_on_the_reference_core(monkeypatch, frames, kw, jax_cores) == want
