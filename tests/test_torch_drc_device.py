"""The port's real-`.drc` decode (`models/drc_device.py`) against the JAX
package's, on the CPU.

The frames are `tests/fixtures/grid.drc` and grids encoded by the port's
native Draco encoder (`codecs/draco/grid.py`). The JAX side is reached
only through its pure paths: `decode_drc` for the floats and faces,
`_fused_batch_fn` for the device stage on the same packed window, and
`_build_batch` on the port's decoded frames; none of them needs the
reference's native Draco library, which races in its build.

Tolerances: unpacked integers, faces, counts, shapes and padding are
identical. The port dequantizes with one FMA for every component; XLA's
CPU code fuses some components and not others, so a dequantized float is
identical where XLA fuses and elsewhere within 1 ulp of the larger of
itself and the product `q * scale` (the one rounding the split form adds:
where `min + q * scale` cancels, that ulp is many of the result's).
Normals are within 2 ulps (XLA's CPU `sqrt` and contractions), NaN
positions identical.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu.codecs.draco import constants as JK
from uvol_tpu.codecs.draco.decoder import decode_drc
from uvol_tpu.models import drc_device as jd
from uvol_tpu_torch import native as tnative
from uvol_tpu_torch.codecs.draco import constants as K
from uvol_tpu_torch.codecs.draco.encoder import AttributeToEncode
from uvol_tpu_torch.codecs.draco.grid import grid_attributes, grid_drc
from uvol_tpu_torch.models import drc_device as td

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
GRID = (FIXTURES / "grid.drc").read_bytes()
MODE_HI = {8: 1 << 8, 10: 1 << 10, 12: 1 << 12, 16: 1 << 15, 32: 1 << 31}


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps (over the ordered bit patterns)."""
    ia, ib = (x.astype(np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _hold_dequant(got: np.ndarray, want: np.ndarray, prod: np.ndarray) -> None:
    """|got - want| within 1 ulp of max(|want|, |prod|), prod ~ q * scale."""
    tol = np.spacing(np.maximum(np.abs(want), np.abs(prod)).astype(np.float32))
    assert (np.abs(got.astype(np.float64) - want) <= tol).all()


def _prod(packed, spec, meta_off, ints):
    """q * scale of a kind-1 spec of `_window`, from its metadata."""
    _t, _k, _m, f, _n, nc, _o, _ml, moff = spec
    meta = packed[meta_off:].view(np.float32)
    scale = meta[moff + f * nc:moff + f * nc + f]
    return ints.astype(np.float32).astype(np.float64) * scale[:, None, None]


def _window(attrs, f: int, nmax: int, seed: int, maxv=(254.0,)):
    """A packed window of random attributes [(kind, mode)], signed values
    in modes 16 and 32 with both extremes; kind 1 has 3 components.
    Returns (packed, specs, meta_off, meta_len, ints per spec)."""
    r = np.random.default_rng(seed)
    chunks, metas, specs, ints_all = [], [], [], []
    off = moff = 0
    for t, (kind, mode) in enumerate(attrs):
        nc = 3 if kind == 1 else 2
        n = f * nmax * nc
        hi = MODE_HI[mode]
        lo = -hi if mode in (16, 32) else 0
        ints = r.integers(lo, hi, n, dtype=np.int64)
        if n >= 2:
            ints[:2] = lo, hi - 1
        by = jd._pack_host(ints, mode)  # int64: the reference's numpy path
        if kind == 1:
            meta = np.concatenate([r.normal(size=f * nc) * 10, r.uniform(1e-4, 1e-2, f)])
        else:
            meta = np.resize(np.asarray(maxv, np.float64), f)
        specs.append((t, kind, mode, f, nmax, nc, off, len(meta), moff))
        chunks.append(by)
        metas.append(meta.astype(np.float32))
        ints_all.append(ints.reshape(f, nmax, nc))
        off += len(by)
        moff += len(meta)
    pad = (-off) % 4
    meta_all = np.concatenate(metas)
    packed = np.concatenate(chunks + [np.zeros(pad, np.uint8), meta_all.view(np.uint8)])
    return packed, tuple(specs), off + pad, len(meta_all), ints_all


def _jax_stage(packed, specs, meta_off, meta_len):
    outs = jd._fused_batch_fn((specs, (meta_off, meta_len)))(jnp.asarray(packed))
    return [np.asarray(o) for o in outs[1:]]


def _port_stage(packed, specs, meta_off, meta_len):
    return [o.numpy() for o in td.fused_batch(torch.from_numpy(packed), specs, meta_off,
                                              meta_len)]


# ---- the device stage: the twin against XLA on the same bytes --------------------------


@pytest.mark.parametrize("mode", [8, 10, 12, 16, 32])
@pytest.mark.parametrize("nmax", [1, 3, 1001])
def test_unpack_is_exact_and_matches_the_reference(mode, nmax):
    """The twin's integers are the packed ones, tails (values off every
    group size) and sign extension included; scale 1 and min 0 show the
    reference's as float(q), which the port's floats equal."""
    packed, specs, mo, ml, ints = _window([(1, mode)], 2, nmax, mode + nmax)
    n = 2 * nmax * 3
    got = td.unpack_plain(torch.from_numpy(packed[:jd._packed_nbytes(n, mode)]), mode, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ints[0].reshape(-1))
    meta = np.zeros(ml, np.float32)
    meta[2 * 3:] = 1.0  # mins 0, scales 1
    packed[mo:] = meta.view(np.uint8)
    want = ints[0].astype(np.float32)
    np.testing.assert_array_equal(_jax_stage(packed, specs, mo, ml)[0], want)
    np.testing.assert_array_equal(_port_stage(packed, specs, mo, ml)[0], want)


@pytest.mark.parametrize("mode", [8, 10, 12, 16, 32])
def test_dequantize_within_an_ulp_of_the_reference(mode):
    packed, specs, mo, ml, ints = _window([(1, mode)], 4, 4096, 10 + mode)
    want = _jax_stage(packed, specs, mo, ml)[0]
    got = _port_stage(packed, specs, mo, ml)[0]
    assert got.shape == want.shape == (4, 4096, 3)
    _hold_dequant(got, want, _prod(packed, specs[0], mo, ints[0]))


def test_xla_fuses_some_dequantize_components_and_not_others():
    """What XLA's CPU code for the reference does at [4, 4096, 3] (mode
    32): components 0 and 1 are one FMA, `fma(q, scale, min)`, on every
    value, component 2 two roundings, `min + round(q * scale)`. The port
    is one FMA everywhere: identical to the reference on 0 and 1, within
    1 ulp on 2."""
    packed, specs, mo, ml, ints = _window([(1, 32)], 4, 4096, 0)
    want = _jax_stage(packed, specs, mo, ml)[0]
    got = _port_stage(packed, specs, mo, ml)[0]
    meta = packed[mo:].view(np.float32)
    mins, scale = meta[:12].reshape(4, 3), meta[12:16]
    q = ints[0].astype(np.float32)
    split = mins[:, None, :] + (q * scale[:, None, None]).astype(np.float32)
    mix = {c: ("fma" if (want[..., c] == got[..., c]).all() else
               "split" if (want[..., c] == split[..., c]).all() else "other") for c in range(3)}
    assert mix == {0: "fma", 1: "fma", 2: "split"}
    assert (got[..., 2] != split[..., 2]).any()  # the two roundings do differ here
    _hold_dequant(got, want, _prod(packed, specs[0], mo, ints[0]))


@pytest.mark.parametrize("mode", [8, 10, 16])
def test_normals_within_two_ulps_of_the_reference(mode):
    maxv = {8: 254.0, 10: 1022.0, 16: 32766.0}[mode]
    packed, specs, mo, ml, _ = _window([(2, mode)], 3, 4096, 20 + mode, maxv=(maxv,))
    want = _jax_stage(packed, specs, mo, ml)[0]
    got = _port_stage(packed, specs, mo, ml)[0]
    assert got.shape == want.shape == (3, 4096, 3)
    assert not np.isnan(got).any()
    assert _ulps(got, want).max() <= 2
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_degenerate_maxv_mirrors_the_reference():
    """maxv 0 (an oct_max_quantized of 1: 0/0 and ±inf) and -1 (a zero
    one): the same NaN positions as the reference, and within 2 ulps
    elsewhere."""
    packed, specs, mo, ml, _ = _window([(2, 8)], 3, 1000, 5, maxv=(254.0, 0.0, -1.0))
    want = _jax_stage(packed, specs, mo, ml)[0]
    got = _port_stage(packed, specs, mo, ml)[0]
    nan = np.isnan(want)
    assert nan.any() and (~nan).any()
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert _ulps(got[~nan], want[~nan]).max() <= 2


def test_a_whole_window_of_attributes():
    """Four attributes in one window (K8's most), the metadata 4-aligned
    after a tail of odd length."""
    attrs = [(1, 12), (1, 10), (2, 8), (1, 16)]
    packed, specs, mo, ml, ints = _window(attrs, 2, 4097, 9)
    end = specs[-1][6] + jd._packed_nbytes(2 * 4097 * 3, 16)
    assert end % 4 and mo == end + (-end) % 4  # the metadata needs a pad
    for spec, q, g, w in zip(specs, ints, _port_stage(packed, specs, mo, ml),
                             _jax_stage(packed, specs, mo, ml), strict=True):
        assert g.shape == w.shape
        if spec[1] == 1:
            _hold_dequant(g, w, _prod(packed, spec, mo, q))
        else:
            assert _ulps(g, w).max() <= 2


def test_wrapper_checks_and_counts_no_cpu_launch():
    packed, specs, mo, ml, _ = _window([(1, 8)], 1, 10, 0)
    before = dict(td.LAUNCHES)
    td.fused_batch(torch.from_numpy(packed), specs, mo, ml)
    assert td.LAUNCHES == before  # a CPU tensor takes the twin
    t = torch.from_numpy(packed)
    bad = (specs[0][:1] + (3,) + specs[0][2:],)
    for args, match in (((t, bad, mo, ml), "unsupported"),
                        ((t, specs, mo, ml + 1), "metadata"),
                        ((t.to(torch.int32), specs, mo, ml), "uint8"),
                        ((t[:10], specs, 0, 0), "outside")):
        with pytest.raises(ValueError, match=match):
            td.fused_batch(*args)


# ---- end to end -------------------------------------------------------------------------


def _grids(count: int, ny: int = 11, nx: int = 17, bits=(11, 10, 8)):
    return [grid_drc(ny, nx, seed, bits) for seed in range(count)]


def _frames(blobs):
    return [tnative.drc_decode_native(b, portable=True) for b in blobs]


def _hold_batch_against_reference(got, want, frames):
    """Identical ints, faces, counts and shapes; floats to the stated
    tolerances (the products from each frame's minimum)."""
    mins = {a[0]: np.stack([fr[3][i][7][4] for fr in frames]).astype(np.float32)
            for i, a in enumerate(frames[0][3])}
    assert got.num_points == want.num_points
    for a, b in zip(got.faces, want.faces, strict=True):
        np.testing.assert_array_equal(a, b)
    assert sorted(got.values) == sorted(want.values)
    for t, w in want.values.items():
        np.testing.assert_array_equal(got.counts[t], want.counts[t])
        g = got.values[t]
        if isinstance(w, list):
            for a, b in zip(g, w, strict=True):
                np.testing.assert_array_equal(a, b)
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape and g.dtype == np.float32
        if t == K.ATT_NORMAL:
            assert _ulps(g, w).max() <= 2
        else:
            _hold_dequant(g, w, w - mins[t][:, None, :w.shape[2]].astype(np.float64))


@pytest.mark.parametrize("case", ["grid_fixture_x3", "port_grids", "port_grids_wide_bits"])
def test_decode_drc_batch_matches_the_reference(case):
    """Whole padded arrays against the reference's `_build_batch` on the
    same decoded frames, and the floats against its pure-Python
    `decode_drc` at 2e-5, as tests/test_drc_device.py holds them."""
    blobs = {"grid_fixture_x3": [GRID] * 3,
             "port_grids": _grids(4),
             "port_grids_wide_bits": _grids(4, 9, 23, bits=(14, 12, 10))}[case]
    got = td.decode_drc_batch(blobs, device="cpu")
    frames = _frames(blobs)
    _hold_batch_against_reference(got, jd._build_batch(frames, as_numpy=True), frames)
    for i, blob in enumerate(blobs):
        mesh = decode_drc(blob)
        np.testing.assert_array_equal(got.faces[i], mesh.faces.astype(np.int32))
        for t in (K.ATT_POSITION, K.ATT_TEX_COORD, K.ATT_NORMAL):
            a = mesh.attribute_by_type(t)
            n = int(got.counts[t][i])
            assert n == len(a.values)
            np.testing.assert_allclose(got.values[t][i, :n].numpy(), a.values,
                                       rtol=2e-5, atol=2e-5)


def test_decode_drc_batch_as_numpy_and_on_one_frame():
    got = td.decode_drc_batch([GRID], device="cpu", as_numpy=True)
    frames = _frames([GRID])
    assert all(isinstance(v, np.ndarray) for v in got.values.values())
    _hold_batch_against_reference(got, jd._build_batch(frames, as_numpy=True), frames)
    assert got.token is None  # no card: nothing to wait on


def test_integer_attributes_stay_host_lists():
    faces, atts = grid_attributes(5, 7, 3)
    gen = (np.arange(35, dtype=np.int32).reshape(-1, 1) * 3) % 17
    atts.append(AttributeToEncode(K.ATT_GENERIC, gen, faces.reshape(-1), 8, integer=True))
    blobs = [tnative.drc_encode_native(faces, atts)] * 2
    got = td.decode_drc_batch(blobs, device="cpu")
    assert isinstance(got.values[K.ATT_GENERIC], list)
    frames = _frames(blobs)
    _hold_batch_against_reference(got, jd._build_batch(frames, as_numpy=True), frames)
    g = decode_drc(blobs[0]).attribute_by_type(JK.ATT_GENERIC)
    np.testing.assert_array_equal(np.asarray(got.values[K.ATT_GENERIC][0]).reshape(-1),
                                  g.values.reshape(-1))


def test_non_uniform_attribute_sets_raise():
    faces, atts = grid_attributes(6, 6, 0)
    two = tnative.drc_encode_native(faces, atts[:2])
    with pytest.raises(ValueError, match="uniform attribute set"):
        td.decode_drc_batch([grid_drc(6, 6, 0), two], device="cpu")
    with pytest.raises(ValueError, match="uniform attribute set"):
        jd._build_batch(_frames([grid_drc(6, 6, 0), two]))


def test_16bit_quantization_high_values_survive_upload():
    """tests/test_drc_device.py's regression on the port: at 16 bits the
    quantized values reach 65,535, so they must ride mode 32, not the
    sign-extending mode 16."""
    assert td._pick_mode(16, False) == 32
    assert td._pick_mode(15, False) == 16
    rng = np.random.default_rng(3)
    nx = ny = 12
    pos = np.array([[i / (nx - 1), j / (ny - 1), 0.0] for i in range(nx) for j in range(ny)],
                   np.float32)
    pos[:, 2] = rng.random(len(pos), np.float32)
    faces = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a, b, c, d = i * ny + j, (i + 1) * ny + j, (i + 1) * ny + j + 1, i * ny + j + 1
            faces += [[a, b, c], [a, c, d]]
    faces = np.array(faces, np.int32)
    blob = tnative.drc_encode_native(
        faces, [AttributeToEncode(K.ATT_POSITION, pos, faces.reshape(-1), 16)])
    q = decode_drc(blob).attribute_by_type(JK.ATT_POSITION)
    batch = td.decode_drc_batch([blob], device="cpu", as_numpy=True)
    n = int(batch.counts[K.ATT_POSITION][0])
    np.testing.assert_allclose(batch.values[K.ATT_POSITION][0, :n], q.values,
                               rtol=2e-5, atol=2e-5)
    frames = _frames([blob])
    assert frames[0][3][0][5].max() >= 2**15  # the values that mode 16 would wrap
    _hold_batch_against_reference(batch, jd._build_batch(frames, as_numpy=True), frames)


def test_standard_coder_stream_is_outside_the_native_path():
    std = (FIXTURES / "grid_std.drc").read_bytes()
    assert tnative.drc_decode_native(std, portable=True) is None
    with pytest.raises(NotImplementedError):
        td.decode_drc_batch([std], device="cpu")
    with pytest.raises(NotImplementedError):
        jd.decode_drc_batch([std])


@pytest.mark.parametrize("window", [1, 3, 8])
def test_decode_drc_stream_windows_equal_batches(window):
    blobs = _grids(5)
    blobs = blobs + blobs[:2]
    seen = 0
    for start, batch in td.decode_drc_stream(blobs, window=window, workers=2, lookahead=2,
                                              device="cpu"):
        ref = td.decode_drc_batch(blobs[start:start + window], device="cpu")
        assert batch.num_points == ref.num_points
        for t, v in ref.values.items():
            np.testing.assert_array_equal(batch.values[t].numpy(), v.numpy())
            np.testing.assert_array_equal(batch.counts[t], ref.counts[t])
        for a, b in zip(batch.faces, ref.faces, strict=True):
            np.testing.assert_array_equal(a, b)
        seen += len(batch.faces)
    assert seen == len(blobs)


def test_dequantize_and_oct_to_unit_match_the_reference_functions():
    """The plain stage functions the bench times apart, against the
    reference's `_dequant_fns` on the same ints."""
    jdeq, joct = jd._dequant_fns()
    r = np.random.default_rng(4)
    ints = r.integers(0, 2048, (3, 500, 3)).astype(np.int32)
    mins = r.normal(size=(3, 3)).astype(np.float32)
    scale = r.uniform(1e-4, 1e-2, 3).astype(np.float32)
    got = td.dequantize(torch.from_numpy(ints), torch.from_numpy(mins), torch.from_numpy(scale))
    _hold_dequant(got.numpy(), np.asarray(jdeq(ints, mins, scale)),
                  ints.astype(np.float64) * scale[:, None, None])
    st = r.integers(0, 255, (3, 500, 2)).astype(np.int32)
    maxv = np.full(3, 254.0, np.float32)
    got = td.oct_to_unit(torch.from_numpy(st), torch.from_numpy(maxv))
    assert _ulps(got.numpy(), np.asarray(joct(st, maxv))).max() <= 2
