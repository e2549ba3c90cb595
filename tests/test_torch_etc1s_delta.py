"""The ETC1S delta-aware stage of the port (uvol_tpu_torch) against the
JAX package, on the CPU.

The endpoint-major flips, the rate sweep (K7's plain twin on the CPU:
`etc1s_cuda.rate_sweep_frame_plain`),
the endpoint quads and the whole delta path of `build_palettes` /
`encode_ktx2_etc1s` take the same inputs as the reference and must give
the same assignments, palettes and `.ktx2` bytes: every comparison is
exact. The reference's palette build takes its Pallas path in interpret
mode (the `jax_kernel_path` fixture, as in tests/test_torch_etc1s.py).
K7 itself is held against its twin on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvol_tpu.codecs.basis import etc1s_encode as jenc
from uvol_tpu.codecs.basis.transcoder import transcode_ktx2_etc1s
from uvol_tpu.containers.ktx2 import read_ktx2
from uvol_tpu_torch._device import fma_f32
from uvol_tpu_torch.codecs.basis import etc1s_cuda as kern
from uvol_tpu_torch.codecs.basis import etc1s_encode as tenc

GRIDS = ("block_endpoint", "block_selector")


@pytest.fixture(scope="module")
def jax_kernel_path():
    """Makes the JAX package's `build_palettes` take its Pallas path, in
    interpret mode, on the CPU (its own rule picks it on a TPU only), for
    the rest of the module: its compiled palette cores are kept between
    tests. Its quad pass gets writable grids: on the delta path its sweeps
    leave `block_selector` a read-only view of a device buffer, and the
    quad pass writes into it (ValueError); the port's grids are writable."""
    quads = jenc.quad_share_endpoints

    def writable_quads(blocks, pal, *args, **kwargs):
        for name in GRIDS:
            setattr(pal, name, np.array(getattr(pal, name)))
        return quads(blocks, pal, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(jenc, "_palette_core_fn",
                   functools.partial(jenc._palette_core_fn, pallas_interpret=True))
        mp.setattr(jenc, "_PALETTE_JIT_CACHE", {})
        mp.setattr(jenc, "quad_share_endpoints", writable_quads)
        yield


def _segment(f: int = 2, h: int = 64, w: int = 64, seed: int = 3) -> np.ndarray:
    """Shifted gradients with noise; frame 1 repeats frame 0 where f > 2."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros((f, h, w, 3), np.uint8)
    for i in range(f):
        img = np.stack([(xx * 4 + i * 8) % 256, (yy * 4) % 256, ((xx + yy) * 2) % 256], -1)
        out[i] = np.clip(img + r.integers(-6, 7, img.shape), 0, 255)
    if f > 2:
        out[1] = out[0]
    return out


def _rgba(frames: np.ndarray) -> np.ndarray:
    f, h, w, _ = frames.shape
    alpha = np.clip(np.mgrid[0:h, 0:w][1] * 4 - np.arange(f)[:, None, None], 0, 255)
    return np.concatenate([frames, alpha[..., None].astype(np.uint8)], -1)


def _pass_inputs(e: int, s: int = 64, uniform: bool = True, seed: int = 0):
    """3 frames of 8 x 12 blocks (frame 1 = frame 0: CR wins there; frame 2
    differs) and a maker of Palettes with E random entries, 8 of them
    duplicated (ties), random assignments, a uniform selector row or not."""
    f, nby, nbx = 3, 8, 12
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:nby * 4, 0:nbx * 4]
    frames = np.zeros((f, nby * 4, nbx * 4, 3), np.uint8)
    for i in range(f):
        img = np.stack([(xx * 5 + i * 3) % 256, (yy * 7) % 256, ((xx + yy) * 3) % 256], -1)
        frames[i] = np.clip(img + r.integers(-20, 21, img.shape), 0, 255)
    frames[1] = frames[0]
    c5 = r.integers(0, 32, (e, 3)).astype(np.uint8)
    inten = r.integers(0, 8, e).astype(np.uint8)
    c5[e // 2:e // 2 + 8], inten[e // 2:e // 2 + 8] = c5[:8], inten[:8]
    sel = r.integers(0, 4, (s, 16)).astype(np.uint8)
    if uniform:
        sel[5], sel[9] = 1, 3
    ep = r.integers(0, e, (f, nby * nbx)).astype(np.int32)
    sl = r.integers(0, s, (f, nby * nbx)).astype(np.int32)
    if uniform:
        sl[:, ::3] = 9

    def pal():
        return jenc.Palettes(c5.copy(), inten.copy(), sel.copy(), ep.copy(), sl.copy())

    return tenc._blocks_of(frames), pal, nby, nbx


def _assert_pal_equal(got, want) -> None:
    for name in ("color5", "inten", "selectors", *GRIDS):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def _psnr(blob: bytes, frames: np.ndarray) -> float:
    out = transcode_ktx2_etc1s(read_ktx2(blob))[..., : frames.shape[-1]]
    return float(10 * np.log10(255.0**2 / ((out.astype(np.float64) - frames) ** 2).mean()))


# ---- what XLA compiles the sweep's bits table into -------------------------


def test_log_table_is_xla_log():
    """L[k] = log(1 + k), k = 0..32,768 (the index distances of palettes
    up to 65,536 entries), bit for bit as XLA's CPU `log` returns it:
    `_xla_log`, Cephes' polynomial with XLA's FMAs, which is one ulp off
    the correctly rounded value at ~1% of them."""
    k = np.arange(32769)
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray((1.0 + k).astype(np.float32))))
    got = tenc._xla_log1p_table(32768)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(tenc._xla_log1p_table()[:1025], got[:1025])
    rounded = np.log((1.0 + k).astype(np.float64)).astype(np.float32)
    assert 100 < np.count_nonzero(rounded != want) < 1000


@pytest.mark.parametrize("e_n", [512, 777, 1024, 1536, 2048, 2049, 3000, 4096, 16128])
def test_sweep_bits_table_matches_xla(e_n):
    """The reference's expression (etc1s_encode.py:1270-1282) jitted: XLA
    folds 1.5 * log2 into one constant and contracts `+ 5.0` into an FMA;
    the port's table has every one of its bits."""

    @jax.jit
    def ref(left):
        iota = jnp.arange(e_n, dtype=jnp.int32)[None, :]
        dm = (iota - left[:, None]) % e_n
        dsig = jnp.minimum(dm, e_n - dm).astype(jnp.float32)
        return jnp.where(dm == 0, 1.2, jnp.where(
            dm == 1, 2.0, 5.0 + 1.5 * jnp.log2(1.0 + dsig) + 0.5 * (dm > e_n // 2)))

    want = np.asarray(ref(jnp.zeros(2, jnp.int32)))[0]
    got = tenc.sweep_bits_table(e_n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fma_rounds_once_as_xla_does():
    """`a * b + c` as XLA compiles it on the CPU (one FMA), on random
    operands and on one where rounding the float64 sum first would land on
    a float32 midpoint."""
    r = np.random.default_rng(2)
    a = (r.standard_normal(4096) * 300).astype(np.float32)
    b = r.standard_normal(4096).astype(np.float32)
    c = r.integers(-3_000_000, 3_000_000, 4096).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)
    x, y = torch.tensor([1 + 2.0**-23]), torch.tensor([-(1 - 2.0**-23)])
    assert fma_f32(x, y, torch.tensor([16777218.0])).item() == 16777218.0
    assert tenc._fma(x, y, torch.tensor([16777218.0])).item() == 16777216.0
    # the encoder's cheap form is exact on its gates: lambda x an error + 64
    err = torch.from_numpy(r.integers(0, 3_100_000, 4096).astype(np.float32))
    for lam in (1.1, 1.25, 1.5, 2.5, 3.0, 7.0, 11.0, 16.0):
        assert torch.equal(tenc._fma(lam, err, 64.0), fma_f32(lam, err, 64.0))


# ---- the passes ------------------------------------------------------------


@pytest.mark.parametrize("uniform", [True, False])
def test_ensure_uniform_selector_matches_jax(uniform):
    """An existing uniform row (the most used one), or the least-used row
    overwritten with code 2."""
    _, pal, _, _ = _pass_inputs(512, uniform=uniform)
    want, got = pal(), pal()
    assert tenc._ensure_uniform_selector(got) == jenc._ensure_uniform_selector(want)
    np.testing.assert_array_equal(got.selectors, want.selectors)
    assert (tenc._ensure_uniform_selector(pal())[0] == 9) == uniform


def _run_pass(name: str, blocks, pal, nby, nbx, **kw):
    want, got = pal(), pal()
    getattr(jenc, name)(want, nby, nbx, dev_blocks=jnp.asarray(blocks), **kw)
    getattr(tenc, name)(got, nby, nbx, dev_blocks=torch.from_numpy(blocks), **kw)
    _assert_pal_equal(got, want)
    return got


@pytest.mark.parametrize("breaks", [(), (2,)])
@pytest.mark.parametrize("lam_bits", [20.0, 60.0, 200.0])
@pytest.mark.parametrize("e_n", [512, 1024])
@pytest.mark.parametrize("name", ["delta_bias_assignments", "rate_sweep_assignments"])
def test_delta_pass_matches_jax(name, e_n, lam_bits, breaks):
    """The flips and the sweep on random assignments, ties among the
    entries, a repeated frame (CR wins there) and one that is not, with
    and without a chain break before the last frame."""
    blocks, pal, nby, nbx = _pass_inputs(e_n, seed=e_n)
    got = _run_pass(name, blocks, pal, nby, nbx, lam_bits=lam_bits, lam_cr=1.5,
                    chain_breaks=breaks)
    ep, sel = got.block_endpoint, got.block_selector
    cr = (ep[1] == ep[0]) & (sel[1] == sel[0])
    assert cr.any() and not (ep == pal().block_endpoint).all()
    if breaks:  # an I-slice: nothing is taken from the previous frame for being there
        assert not ((ep[2] == ep[1]) & (sel[2] == sel[1])).all()


@pytest.mark.parametrize("name", ["delta_bias_assignments", "rate_sweep_assignments"])
def test_delta_pass_matches_jax_above_the_window(name):
    """The flips and the sweep (K7's twin) at E = 3,000, past the
    kernels' window of 2,048 entries, as above."""
    blocks, pal, nby, nbx = _pass_inputs(3000, seed=3000)
    pal0 = pal()
    pal0.block_endpoint[:, ::2] = 2048 + pal0.block_endpoint[:, ::2] % 952  # entries past 2,047
    got = _run_pass(name, blocks, lambda: copy.deepcopy(pal0), nby, nbx, lam_bits=60.0,
                    lam_cr=1.5, chain_breaks=(2,))
    assert not (got.block_endpoint == pal0.block_endpoint).all()
    assert (got.block_endpoint >= 2048).any()


@pytest.mark.parametrize("e_n", [512, 1024])
def test_delta_stage_matches_jax_after_each_pass(e_n):
    """The tail of `build_palettes` on a built palette: the flips at 2.5x
    lambda, three rounds of relabel and sweep, a last relabel; the
    palettes and grids equal after every step."""
    frames = _segment(f=3, h=64, w=96)
    nby, nbx = 16, 24
    pal = tenc.build_palettes(frames, e_n, 256, delta_window=0, device="cpu")
    blocks = tenc._blocks_of(frames)
    want, got = copy.deepcopy(pal), copy.deepcopy(pal)
    kw = dict(lam_cr=1.5, chain_breaks=(2,))
    jenc.delta_bias_assignments(want, nby, nbx, dev_blocks=jnp.asarray(blocks),
                                lam_bits=150.0, **kw)
    tenc.delta_bias_assignments(got, nby, nbx, dev_blocks=torch.from_numpy(blocks),
                                lam_bits=150.0, **kw)
    _assert_pal_equal(got, want)
    for _ in range(3):
        jenc.reorder_endpoint_palette(want)
        tenc.reorder_endpoint_palette(got)
        _assert_pal_equal(got, want)
        jenc.rate_sweep_assignments(want, nby, nbx, dev_blocks=jnp.asarray(blocks),
                                    lam_bits=60.0, **kw)
        tenc.rate_sweep_assignments(got, nby, nbx, dev_blocks=torch.from_numpy(blocks),
                                    lam_bits=60.0, **kw)
        _assert_pal_equal(got, want)
    assert not np.array_equal(got.block_endpoint, pal.block_endpoint)


def test_sweep_near_ties_follow_the_compiled_reference():
    """One row of two flat blocks. The first is black and settles on entry
    0, the left of the second; the second (gray 253) is nearest entry A =
    46 (gray 80, error 1,436,592) and next entry B = 2 (gray 73, error
    1,555,200), every other entry black. Over 401 lambdas around the one
    where A and B cost the same, the winner depends on the bits of XLA's
    `log(47)` (one ulp above the correctly rounded value) and on the FMA:
    the port picks as the reference does at every one, where a correctly
    rounded log and a product rounded before the add each pick otherwise
    somewhere."""
    e_n, a, b = 1024, 46, 2
    err_a, err_b = 48.0 * 173**2, 48.0 * 180**2
    c5 = np.zeros((e_n, 3), np.uint8)
    inten = np.zeros(e_n, np.uint8)
    c5[a] = c5[b] = 10  # 82: code 1 of table 0 (-2) gives 80, of table 2 (-9) 73
    inten[b] = 2
    sel = np.ones((2, 16), np.uint8)  # uniform rows of code 1
    px = np.zeros((2, 16, 3), np.uint8)
    px[1] = 253
    bits = tenc.sweep_bits_table(e_n)
    rounded_a = np.float32(np.float64(np.float32(np.log(47.0))) * tenc._LOG2_X15 + 5.0)
    assert rounded_a != bits[a]
    lam0 = np.float32((err_b - err_a) / (float(bits[a]) - float(bits[b])))
    lams = lam0 + np.arange(-200, 201, dtype=np.float32) * 4 * np.spacing(lam0)

    def pick(cost_a, cost_b):
        return a if cost_a < cost_b else b

    zeros = np.zeros((1, 2), np.int32)
    winners, other_log, unfused = set(), 0, 0
    for lam in lams:
        want = jenc.Palettes(c5, inten, sel, zeros.copy(), zeros.copy())
        got = jenc.Palettes(c5, inten, sel, zeros.copy(), zeros.copy())
        jenc.rate_sweep_assignments(want, 1, 2, dev_blocks=jnp.asarray(px), lam_bits=float(lam))
        tenc.rate_sweep_assignments(got, 1, 2, dev_blocks=torch.from_numpy(px),
                                    lam_bits=float(lam))
        _assert_pal_equal(got, want)
        win = int(got.block_endpoint[0, 1])
        winners.add(win)
        fused = lambda x: fma_f32(float(lam), torch.tensor([x[0]]), x[1]).item()  # noqa: E731
        other_log += pick(fused((rounded_a, err_a)), fused((bits[b], err_b))) != win
        unfused += pick(np.float32(lam * bits[a]) + np.float32(err_a),
                        np.float32(lam * bits[b]) + np.float32(err_b)) != win
    assert winners == {a, b} and other_log and unfused


@pytest.mark.parametrize("tau", [2048.0, 1e5])
def test_quad_share_matches_jax(jax_kernel_path, tau):
    frames = _segment()
    pal = tenc.build_palettes(frames, 512, 512, delta_window=16, device="cpu")
    blocks = tenc._blocks_of(frames).reshape(2, -1, 16, 3)
    want, got = copy.deepcopy(pal), copy.deepcopy(pal)
    jenc.quad_share_endpoints(blocks, want, 16, 16, tau=tau)
    tenc.quad_share_endpoints(blocks, got, 16, 16, tau=tau, device="cpu")
    _assert_pal_equal(got, want)
    assert (got.block_endpoint != pal.block_endpoint).any()


def test_quad_share_refuses_an_odd_grid():
    frames = np.zeros((1, 24, 32, 3), np.uint8)  # 6 x 8 blocks: even; 6 x 7 below
    pal = tenc.build_palettes(frames[:, :, :28], 8, 8, device="cpu")
    with pytest.raises(ValueError, match="endpoint quads need an even block grid, got 6x7"):
        tenc.quad_share_endpoints(tenc._blocks_of(frames[:, :, :28]), pal, 6, 7, device="cpu")


def test_rate_sweep_wrapper_refuses_other_shapes():
    blocks = torch.zeros((12, 16, 3), dtype=torch.uint8)
    base, mods = torch.zeros((512, 3), dtype=torch.int32), torch.zeros((512, 4), dtype=torch.int32)
    sel_cb, bits = torch.zeros((4, 16), dtype=torch.int32), torch.zeros(512)
    z = torch.zeros(12, dtype=torch.int32)
    args = (blocks, base, mods, sel_cb, bits, z, z, (z, z), 0, 60.0, 1.5)
    with pytest.raises(ValueError, match="rows of 5"):
        kern.rate_sweep_frame(*args, 5)
    # a palette past the kernel's register path (2,048 entries) is taken
    wide = [torch.zeros((2049, c), dtype=torch.int32) for c in (3, 4)]
    got = kern.rate_sweep_frame(blocks, *wide, sel_cb, torch.zeros(2049), *args[5:], 4)
    assert [t.shape for t in got] == [(12,), (12,)]
    with pytest.raises(ValueError, match="palette entry"):
        kern.rate_sweep_frame(blocks, base[:0], *args[2:], 4)
    with pytest.raises(ValueError, match="uint8 blocks"):
        kern.rate_sweep_frame(blocks.int(), *args[1:], 4)
    with pytest.raises(ValueError, match="bits"):
        kern.rate_sweep_frame(*args[:4], bits.double(), *args[5:], 4)
    with pytest.raises(ValueError, match="prev_ep"):
        kern.rate_sweep_frame(*args[:7], (z.long(), z), *args[8:], 4)
    assert [t.shape for t in kern.rate_sweep_frame(*args, 4)] == [(12,), (12,)]


def test_delta_entropy_proxy_matches_jax():
    grid = np.random.default_rng(4).integers(0, 512, (6, 40)).astype(np.int32)
    grid[:, 10:20] = 3
    assert tenc._delta_entropy_proxy(grid, 512) == jenc._delta_entropy_proxy(grid, 512)
    assert tenc._delta_entropy_proxy(np.zeros((2, 5), np.int32), 512) == 0.0


# ---- the whole delta path ----------------------------------------------------


def test_build_palettes_delta_path_matches_jax_kernel_path(jax_kernel_path):
    frames = _segment()
    want = jenc.build_palettes(frames, 512, 512, delta_window=16, rdo_chain_breaks=(1,))
    got = tenc.build_palettes(frames, 512, 512, delta_window=16, rdo_chain_breaks=(1,),
                              device="cpu")
    _assert_pal_equal(got, want)


@pytest.mark.parametrize("quads", [False, True])
@pytest.mark.parametrize("kind", ["rgb_512", "rgba_1024"])
def test_encode_delta_path_matches_jax_kernel_path(jax_kernel_path, kind, quads):
    """2 x 64x64 RGB at 512/512, and RGBA at 1024/1024 (alpha doubles the
    blocks to 1,024), with the defaults' delta window and lambda: the bytes
    equal the JAX package's and decode at >= 24 dB."""
    frames = _segment() if kind == "rgb_512" else _rgba(_segment())
    e_n = int(kind.split("_")[1])
    kw = dict(num_endpoints=e_n, num_selectors=e_n, endpoint_quads=quads)
    want = jenc.encode_ktx2_etc1s(frames, **kw)
    got = tenc.encode_ktx2_etc1s(frames, device="cpu", **kw)
    assert got == want
    assert read_ktx2(got).basis_lz.endpoint_count == e_n
    assert _psnr(got, frames) >= 24.0


def test_encode_auto_sizes_on_noisy_content(jax_kernel_path):
    """Noise is hard content: "auto" asks for 1,536 endpoints, 512 blocks
    give 512, and the delta path runs."""
    frames = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    assert tenc.choose_codebook_sizes(frames) == (1536, 768)
    kw = dict(num_endpoints="auto", num_selectors="auto")
    assert tenc.encode_ktx2_etc1s(frames, device="cpu", **kw) == jenc.encode_ktx2_etc1s(frames, **kw)


def test_rate_target_matches_jax(jax_kernel_path, monkeypatch):
    """A target between the ladder's third step (3,058 bytes) and the two
    before it (3,355): the walk takes three encodes, the last with
    lam_cr = 3.0, and returns the reference's bytes."""
    kw = dict(num_endpoints=512, num_selectors=512)
    steps = []
    encode = tenc.encode_ktx2_etc1s
    monkeypatch.setattr(tenc, "encode_ktx2_etc1s",
                        lambda f, **k: steps.append(k) or encode(f, **k))
    got = tenc.encode_ktx2_etc1s_rate_target(_segment(), 3200, device="cpu", **kw)
    assert got == jenc.encode_ktx2_etc1s_rate_target(_segment(), 3200, **kw)
    assert len(got) == 3058
    assert len(steps) == 3 and steps[-1]["rdo_lambdas"][2] >= 3.0
