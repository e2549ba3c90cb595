"""Inputs, the reference's kernel path and a check shared by the port's
ETC1S tests (tests/test_torch_etc1s*.py). Not a test module: pytest
collects only `test_*.py`.

On the CPU the JAX package's `build_palettes` takes its XLA fallback (bf16
k-means dots); the port follows its Pallas path, so the tests make the
reference take that path in interpret mode (`take_jax_kernel_path`).
"""

import functools

import jax
import numpy as np

from uvol_tpu.codecs.basis import etc1s_encode as jenc
from uvol_tpu.codecs.basis.transcoder import transcode_ktx2_etc1s
from uvol_tpu.containers.ktx2 import read_ktx2
from uvol_tpu_torch.codecs.basis import etc1s_encode as tenc

INTEN = np.asarray(jenc.INTEN_TABLES, np.int32)
GRIDS = ("block_endpoint", "block_selector")


def take_jax_kernel_path(mp, on_core=None, writable_quads: bool = False) -> None:
    """Through the MonkeyPatch `mp`: the JAX package's `build_palettes`
    takes its Pallas path, in interpret mode, on the CPU (its own rule
    picks it on a TPU only), with no palette core compiled yet.

    `on_core` is handed the outputs of every palette core the reference
    runs, as numpy arrays in the core's order (base5, inten, sel_cb,
    assign, sel_assign), when the core has run. With `writable_quads` its
    quad pass gets writable grids: on the delta path its sweeps leave
    `block_selector` a read-only view of a device buffer, and the quad pass
    writes into it (ValueError); the port's grids are writable."""
    core_fn = functools.partial(jenc._palette_core_fn, pallas_interpret=True)
    mp.setattr(jax, "default_backend", lambda: "tpu")
    mp.setattr(jenc, "_palette_core_fn",
               core_fn if on_core is None else _recording(core_fn, on_core))
    mp.setattr(jenc, "_PALETTE_JIT_CACHE", {})
    if writable_quads:
        quads = jenc.quad_share_endpoints

        def writable(blocks, pal, *args, **kwargs):
            for name in GRIDS:
                setattr(pal, name, np.array(getattr(pal, name)))
            return quads(blocks, pal, *args, **kwargs)

        mp.setattr(jenc, "quad_share_endpoints", writable)


def _recording(core_fn, on_core):
    """`core_fn` whose cores also hand their outputs to `on_core` (a host
    callback in the compiled core; the outputs are unchanged)."""

    def make(*args, **kwargs):
        body = core_fn(*args, **kwargs)

        def core(blocks):
            outs = body(blocks)
            jax.debug.callback(lambda *o: on_core([np.array(x) for x in o]), *outs)
            return outs

        return core

    return make


def _blocks(n: int, seed: int) -> np.ndarray:
    """n random [16, 3] blocks with flat blocks (0, 255, mid-gray) and
    saturating ones at the front."""
    b = np.random.default_rng(seed).integers(0, 256, (n, 16, 3)).astype(np.uint8)
    b[0], b[1], b[2] = 0, 255, 128
    b[3, :, 0], b[3, :, 1], b[3, :, 2] = 255, 0, 7
    b[4] = b[5]  # duplicate blocks tie on every candidate
    return b


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


def _psnr(blob: bytes, frames: np.ndarray) -> float:
    out = transcode_ktx2_etc1s(read_ktx2(blob))[..., : frames.shape[-1]]
    return float(10 * np.log10(255.0**2 / ((out.astype(np.float64) - frames) ** 2).mean()))


def hold_delta_encode(kind: str, quads: bool) -> None:
    """The whole delta path on `kind` ("rgb_512": 2 x 64x64 RGB at
    512/512; "rgba_1024": RGBA at 1024/1024, alpha doubling the blocks to
    1,024), with the defaults' delta window and lambda: the bytes equal the
    JAX package's and decode at >= 24 dB. Needs `take_jax_kernel_path`."""
    frames = _segment() if kind == "rgb_512" else _rgba(_segment())
    e_n = int(kind.split("_")[1])
    kw = dict(num_endpoints=e_n, num_selectors=e_n, endpoint_quads=quads)
    want = jenc.encode_ktx2_etc1s(frames, **kw)
    got = tenc.encode_ktx2_etc1s(frames, device="cpu", **kw)
    assert got == want
    assert read_ktx2(got).basis_lz.endpoint_count == e_n
    assert _psnr(got, frames) >= 24.0
