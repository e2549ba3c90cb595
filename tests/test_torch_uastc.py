"""U1, the UASTC device fit, against the reference's XLA program on the CPU.

`uastc.device_fit_plain` is the plain twin of the reference's
`_device_fit_fn(modes)(px)`; it must equal what XLA computes bit for bit
(tolerance 0 on every field, the float32 error included) for every
device-eligible mode, alone and in the mode lists the encoder uses, on
random, smooth, solid, two-color, alpha-ramp, degenerate-axis and
halfway blocks. `uastc_cuda.device_fit` on a CPU tensor (the twin and the
first minimum of the error) must pick the reference's winners, and
`encode_uastc_blocks(device_fit=True)` must write the reference's
`device=True` bytes. A numpy model of the kernel's integer formulation
(`csrc/uastc.cu`) is held against the twin here; the kernel itself
against the twin on the card (tests/test_torch_cuda.py).
"""

import warnings

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu.codecs.basis import uastc as J
from uvol_tpu_torch._device import fma_f32
from uvol_tpu_torch.codecs.basis import uastc as T
from uvol_tpu_torch.codecs.basis import uastc_cuda as TC

ELIGIBLE = [0, 1, 2, 5, 10, 11, 12, 13, 14, 17, 18]
MODE_SETS = {"rgb": [0, 5], "rgba": [10, 12], "all": ELIGIBLE}
N = 512  # blocks of every kind: one batch shape, one XLA compile per mode list


def _halfway_blocks(n: int) -> np.ndarray:
    """Blocks whose red channel spans 0..128 with one pixel at 2m, m the
    midpoint of two neighbouring entries of a weight table: w64 lands
    exactly between them (the first minimum must win)."""
    mids = sorted({(a + b) / 2 for t in J.WEIGHT_TABLES.values() for a, b in zip(t, t[1:])})
    px = np.zeros((n, 16, 4), np.uint8)
    px[..., 1] = 40
    px[..., 2] = 90
    px[..., 3] = 255
    for i in range(n):
        px[i, 0, 0] = 0
        px[i, 1:, 0] = 128
        px[i, 2 + i % 14, 0] = int(2 * mids[i % len(mids)])
        if i % 2:
            px[i, ..., 3] = px[i, ..., 0]  # the same on the alpha plane
    return px


def _blocks(kind: str, n: int = N, seed: int = 0) -> np.ndarray:
    """[n, 16, 4] uint8 blocks of one kind."""
    r = np.random.default_rng(seed)
    if kind == "random":
        return r.integers(0, 256, (n, 16, 4)).astype(np.uint8)
    if kind == "smooth":
        lo = r.integers(0, 200, (n, 1, 4))
        return np.clip(lo + r.integers(0, 56, (n, 16, 4)), 0, 255).astype(np.uint8)
    if kind == "solid":
        return np.broadcast_to(r.integers(0, 256, (n, 1, 4)), (n, 16, 4)).astype(np.uint8)
    if kind == "two_color":
        a, b = r.integers(0, 256, (2, n, 1, 4))
        pick = r.integers(0, 2, (n, 16, 1)).astype(bool)
        return np.where(pick, a, b).astype(np.uint8)
    if kind == "alpha_ramp":
        px = r.integers(0, 256, (n, 16, 4)).astype(np.uint8)
        px[..., 3] = np.linspace(0, 255, 16).astype(np.uint8)[None] // (1 + r.integers(0, 4, (n, 1)))
        return px
    if kind == "degenerate":  # denom == 0 on a plane: every channel, or RGB only
        px = np.broadcast_to(r.integers(0, 256, (n, 1, 4)), (n, 16, 4)).astype(np.uint8).copy()
        px[n // 2:, :, 3] = r.integers(0, 256, (n - n // 2, 16))
        px[: n // 4, :, 3] = 255
        return px
    if kind == "halfway":
        return _halfway_blocks(n)
    raise ValueError(kind)


KINDS = ["random", "smooth", "solid", "two_color", "alpha_ramp", "degenerate", "halfway"]


def _assert_fields_equal(got, want, what=""):
    for k, (g, w) in enumerate(zip(got, want, strict=True)):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        if w.dtype == np.float32:  # bit for bit, the sign of a zero included
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("modes", list(MODE_SETS), ids=list(MODE_SETS))
@pytest.mark.parametrize("kind", KINDS)
def test_device_fit_plain_equals_xla_bit_for_bit(kind, modes):
    px = _blocks(kind)
    mode_ids = MODE_SETS[modes]
    want = J._device_fit_fn(tuple(mode_ids))(px)
    got = T.device_fit_plain(torch.from_numpy(px), mode_ids)
    for mid, g, w in zip(mode_ids, got, want, strict=True):
        _assert_fields_equal(g, w, f"mode {mid}")


@pytest.mark.parametrize("mode", ELIGIBLE)
def test_each_eligible_mode_alone(mode):
    px = np.concatenate([_blocks(k, 64, seed=mode) for k in KINDS])
    (want,) = J._device_fit_fn((mode,))(px)
    (got,) = T.device_fit_plain(torch.from_numpy(px), [mode])
    _assert_fields_equal(got, want, f"mode {mode}")


def test_eligible_modes_are_the_reference_rule():
    rule = [mid for mid, m in J.MODES.items()
            if m.subsets == 1 and m.cem != 4 and not (m.dual_plane and m.cem != 12)]
    assert list(T.DEVICE_FIT_MODES) == rule == ELIGIBLE


def _reference_winners(px: np.ndarray, modes) -> tuple:
    """The reference's selection: errs.argmin(0) over the XLA fields."""
    fits = J._device_fit_fn(tuple(modes))(px)
    errs = np.stack([np.asarray(f[4]) for f in fits])
    win = errs.argmin(0)
    b = np.arange(len(px))
    fields = []
    for k in range(4):
        arrs = [np.asarray(f[k]) for f in fits]
        width = 4 if k < 2 else 16
        out = np.zeros((len(px), width), np.uint8)
        for mi, a in enumerate(arrs):
            sel = win == mi
            out[sel, : a.shape[1]] = a[sel]
        fields.append(out)
    return (win.astype(np.uint8), *fields, errs[win, b])


@pytest.mark.parametrize("modes", list(MODE_SETS), ids=list(MODE_SETS))
def test_wrapper_on_the_cpu_picks_the_reference_winners(modes):
    px = np.concatenate([_blocks(k, 64, seed=3) for k in KINDS])
    got = TC.device_fit(torch.from_numpy(px), MODE_SETS[modes])
    want = _reference_winners(px, MODE_SETS[modes])
    _assert_fields_equal(got, want)


def test_ties_go_to_the_first_mode_in_the_callers_order():
    """Solid blocks score 0 in every RGB mode: the first mode listed wins,
    whichever it is."""
    px = _blocks("solid", 64)
    px[..., 3] = 255
    for modes in ([0, 5], [5, 0], [18, 1, 2]):
        win = TC.device_fit(torch.from_numpy(px), modes)[0]
        assert (win.numpy() == 0).all()
        np.testing.assert_array_equal(win.numpy(), _reference_winners(px, modes)[0])


def test_plain_twin_chunks_give_the_whole_batch():
    px = torch.from_numpy(np.concatenate([_blocks(k, 40, seed=5) for k in KINDS]))
    whole = TC.device_fit_select_plain(px, ELIGIBLE)
    for a, b in zip(TC.device_fit_select_plain(px, ELIGIBLE, chunk=33), whole):
        assert torch.equal(a, b)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    px = torch.from_numpy(_blocks("random", 8))
    for modes in ([3], [0, 15], [6], []):
        with pytest.raises(ValueError, match="modes"):
            TC.device_fit(px, modes)
    with pytest.raises(ValueError, match="uint8"):
        TC.device_fit(px.to(torch.int32), [0])
    with pytest.raises(ValueError, match="16, 4"):
        TC.device_fit(px.reshape(8, 64, 1), [0])


# ---- the kernel's formulation, modelled in numpy -------------------------------


def _nearest_weight(w64: np.ndarray, table: np.ndarray) -> np.ndarray:
    """The kernel's closed-form nearest entry (`nearest_weight`): c =
    floor(w64 * f32((L - 1) / 64)), at most L - 2, then c + 1 where its
    |w64 - table| is strictly less, all in float32."""
    levels = len(table)
    tf = table.astype(np.float32)
    f = np.float32(levels - 1) * np.float32(1 / 64)
    c = np.minimum((w64.astype(np.float32) * f).astype(np.float32).astype(np.int64), levels - 2)
    d0 = np.abs((w64 - tf[c]).astype(np.float32))
    d1 = np.abs((w64 - tf[c + 1]).astype(np.float32))
    return np.where(d1 < d0, c + 1, c)


def _kernel_model(px: np.ndarray, modes) -> tuple:
    """csrc/uastc.cu in numpy, a block on 4 lanes of 4 pixels each: the
    per-channel minimum and maximum of each lane's pixels, then of the 4
    lanes; w64 once per plane layout (RGB, RGBA, alpha) for every mode
    that uses it, t an IEEE division of two exact integers; the nearest
    weight in closed form; the endpoints scaled in float32; each lane's
    integer error sum over its pixels, then the 4 lanes' sum; the error in
    float32 (an FMA for RGB modes); the first minimum over the modes."""
    p = px.astype(np.int64).reshape(len(px), 4, 4, 4)  # [block, lane, pixel, channel]
    lo = p.min(2).min(1)  # the lanes' minima, then the quad's
    hi = p.max(2).max(1)
    rows = TC.mode_rows(modes)

    def plane_w64(c0, c1):
        d = hi[:, c0:c1] - lo[:, c0:c1]
        denom = (d * d).sum(-1)[:, None, None]
        num = ((p[..., c0:c1] - lo[:, None, None, c0:c1]) * d[:, None, None]).sum(-1)
        with np.errstate(invalid="ignore", divide="ignore"):
            t = np.where(denom > 0, num.astype(np.float32) / denom.astype(np.float32),
                         np.float32(0.5)).astype(np.float32)
        return (np.clip(t, np.float32(0), np.float32(1)) * np.float32(64)).astype(np.float32)

    w = {"rgb": plane_w64(0, 3), "rgba": plane_w64(0, 4), "a": plane_w64(3, 4)}
    sa = ((255 - p[..., 3]) ** 2).sum(2).sum(1)  # each lane's sum, then the quad's
    best = None
    for i, row in enumerate(rows):
        nc, dual, bits, levels = (int(v) for v in row[:4])
        k, inv_n = row[4:6].view(np.float32)
        table = row[8:8 + levels].astype(np.int64)
        wm = _nearest_weight(w["rgb" if dual or nc == 3 else "rgba"], table)  # [block, lane, pixel]
        wa = _nearest_weight(w["a"], table) if dual else np.zeros_like(wm)
        scale = (1 << bits) - 1
        q0 = np.clip(np.rint((lo[:, :nc].astype(np.float32) * k).astype(np.float32)), 0, scale)
        q1 = np.clip(np.rint((hi[:, :nc].astype(np.float32) * k).astype(np.float32)), 0, scale)
        q0, q1 = q0.astype(np.int64), q1.astype(np.int64)
        x0 = q0 if bits == 8 else (q0 << (8 - bits)) | (q0 >> (2 * bits - 8))
        x1 = q1 if bits == 8 else (q1 << (8 - bits)) | (q1 >> (2 * bits - 8))
        lane_sq = np.zeros((len(p), 4), np.int64)
        for c in range(nc):
            wv = table[wa if (dual and c == 3) else wm]
            c0v = ((x0[:, c] << 8) | x0[:, c])[:, None, None]
            c1v = ((x1[:, c] << 8) | x1[:, c])[:, None, None]
            rec = ((c0v * (64 - wv) + c1v * wv + 32) >> 6) >> 8
            lane_sq += ((rec - p[..., c]) ** 2).sum(2)
        sq = lane_sq.sum(1)
        if nc == 3:
            err = fma_f32(torch.from_numpy(sq.astype(np.float32)), float(inv_n),
                          torch.from_numpy((sa.astype(np.float32) * np.float32(0.0625)))).numpy()
        else:
            err = (sq.astype(np.float32) * inv_n).astype(np.float32)
        q0p = np.zeros((len(p), 4), np.uint8)
        q1p = np.zeros((len(p), 4), np.uint8)
        q0p[:, :nc], q1p[:, :nc] = q0, q1
        cand = (np.full(len(p), i, np.uint8), q0p, q1p, wm.reshape(-1, 16).astype(np.uint8),
                wa.reshape(-1, 16).astype(np.uint8), err)
        if best is None:
            best = list(cand)
            continue
        take = err < best[5]
        for f, v in enumerate(cand):
            best[f] = np.where(take.reshape(-1, *([1] * (v.ndim - 1))), v, best[f])
    return tuple(best)


def _gradient_blocks(n: int, seed: int) -> np.ndarray:
    """Linear ramps over the block, per channel, as the bench's smooth
    texture holds them."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:4, 0:4]
    base = r.integers(0, 180, (n, 1, 4))
    slope = r.integers(-20, 21, (n, 2, 4))
    px = base + x.reshape(1, 16, 1) * slope[:, :1] + y.reshape(1, 16, 1) * slope[:, 1:]
    px[..., 3] = 255
    return np.clip(px, 0, 255).astype(np.uint8)


MODEL_KINDS = KINDS + ["gradient"]


def _model_blocks(kind: str, n: int, seed: int) -> np.ndarray:
    return _gradient_blocks(n, seed) if kind == "gradient" else _blocks(kind, n, seed)


@pytest.mark.parametrize("modes", list(MODE_SETS), ids=list(MODE_SETS))
def test_kernel_model_equals_the_twin(modes):
    px = np.concatenate([_model_blocks(k, 64, seed=9) for k in MODEL_KINDS])
    want = TC.device_fit_select_plain(torch.from_numpy(px), MODE_SETS[modes])
    got = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in _kernel_model(px, MODE_SETS[modes]))
    _assert_fields_equal(got, tuple(w.numpy() for w in want))


@pytest.mark.parametrize("mode", ELIGIBLE)
@pytest.mark.parametrize("kind", ["random", "solid", "two_color", "gradient", "alpha_ramp"])
def test_kernel_lane_split_equals_the_twin_for_each_mode(kind, mode):
    """The quad's lane sums and the once-per-layout w64, mode by mode,
    against `device_fit_plain` (every field, the error bit for bit)."""
    px = _model_blocks(kind, 96, seed=mode)
    want = TC.device_fit_select_plain(torch.from_numpy(px), [mode])
    got = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in _kernel_model(px, [mode]))
    _assert_fields_equal(got, tuple(w.numpy() for w in want), f"mode {mode}")


def _weight_probe_floats(table: np.ndarray, seed: int) -> np.ndarray:
    """float32 in [0, 64]: every float within 4,096 ulps of each entry and
    of each midpoint of two neighbours, 0, 64, subnormals, 10^6 random."""
    r = np.random.default_rng(seed)
    marks = np.concatenate([table, (table[1:] + table[:-1]) / 2]).astype(np.float32)
    near = marks.view(np.int32)[:, None] + np.arange(-4096, 4097, dtype=np.int32)[None]
    sub = np.concatenate([np.arange(1, 4097), 0x007FFFFF - np.arange(4096)]).astype(np.int32)
    w = np.concatenate([near.ravel().view(np.float32), sub.view(np.float32),
                        np.float32([0.0, 64.0]), (r.random(10 ** 6) * 64).astype(np.float32)])
    return w[(w >= 0) & (w <= 64)]


@pytest.mark.parametrize("levels", sorted(J.WEIGHT_TABLES))
def test_closed_form_weight_index_equals_the_scan(levels):
    """The kernel's nearest weight entry in closed form against the
    twin's scan (`weight_index_plain`, the first minimum of |w64 - t|)."""
    table = np.asarray(J.WEIGHT_TABLES[levels], np.int64)
    w = _weight_probe_floats(table, levels)
    want = TC.weight_index_plain(torch.from_numpy(w), levels).numpy()
    np.testing.assert_array_equal(_nearest_weight(w, table), want)
    np.testing.assert_array_equal(TC.weight_index(torch.from_numpy(w), levels).numpy(), want)


def test_weight_index_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        TC.weight_index(torch.zeros(4, dtype=torch.float64), 16)
    with pytest.raises(ValueError):
        TC.weight_index(torch.zeros(4), 6)


def test_mode_rows_hold_the_twins_constants():
    rows = TC.mode_rows(ELIGIBLE)
    assert rows.shape == (11, 24) and rows.dtype == np.int32
    for row, mid in zip(rows, ELIGIBLE):
        m = T.MODES[mid]
        nc = 4 if m.cem == 12 else 3
        assert list(row[:4]) == [nc, int(m.dual_plane), m.ep_bits, m.weight_levels]
        k, inv_n = row[4:6].view(np.float32)
        assert k == np.float32(((1 << m.ep_bits) - 1) / 255.0) and inv_n == np.float32(1 / (16 * nc))
        np.testing.assert_array_equal(row[8:8 + m.weight_levels], J.WEIGHT_TABLES[m.weight_levels])
        assert not row[8 + m.weight_levels:].any() and not row[6:8].any()


# ---- encode_uastc_blocks and encode_uastc_ktx2 ---------------------------------


def _smooth(h=64, w=64, alpha=False):
    yy, xx = np.mgrid[0:h, 0:w]
    a = (xx * 4) % 256 if alpha else np.full_like(xx, 255)
    return np.stack([xx * 4 % 256, yy * 4 % 256, (xx + yy) * 2 % 256, a], -1).astype(np.uint8)


@pytest.mark.parametrize("modes", [None, [0, 5], [10, 12], ELIGIBLE, [11, 13, 17]],
                         ids=["default", "rgb", "rgba", "all", "dual"])
@pytest.mark.parametrize("content", ["smooth", "alpha", "blocks"])
def test_device_fit_encode_writes_the_reference_bytes(content, modes):
    if content == "blocks":
        px = np.concatenate([_blocks(k, 64, seed=11) for k in KINDS]).reshape(-1, 4, 4, 4)
    else:
        px = J.image_to_blocks_rgba(_smooth(64, 96, alpha=content == "alpha"))
    want = J.encode_uastc_blocks(px, modes, device=True)
    before = TC.LAUNCHES["uastc_device_fit"]
    got = T.encode_uastc_blocks(px, modes, device_fit=True, device="cpu")
    assert TC.LAUNCHES["uastc_device_fit"] == before  # the CPU takes the twin
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nblocks", [16383, 16384])
def test_auto_takes_the_device_fit_from_16384_blocks(monkeypatch, nblocks):
    px = np.repeat(J.image_to_blocks_rgba(_smooth(128, 128)), 16, axis=0)[:nblocks]
    px = (px.astype(np.int64) + np.arange(nblocks)[:, None, None, None] % 7).clip(0, 255)
    px = px.astype(np.uint8)
    calls = []
    fit = TC.device_fit
    monkeypatch.setattr(TC, "device_fit", lambda *a: calls.append(1) or fit(*a))
    got = T.encode_uastc_blocks(px, device="cpu")  # device_fit="auto"
    assert len(calls) == (nblocks >= 16384)
    np.testing.assert_array_equal(got, J.encode_uastc_blocks(px))  # the reference's "auto"


def test_auto_stays_on_the_host_for_modes_the_fit_does_not_take(monkeypatch):
    px = J.image_to_blocks_rgba(_smooth(32, 32))
    monkeypatch.setattr(TC, "device_fit", lambda *a: pytest.fail("device fit called"))
    for modes in ([3], [0, 6], [15], [16]):
        np.testing.assert_array_equal(
            T.encode_uastc_blocks(px, modes, device_fit=True, device="cpu"),
            J.encode_uastc_blocks(px, modes, device=True))


def test_a_failed_device_fit_raises_where_the_reference_warns(monkeypatch):
    px = J.image_to_blocks_rgba(_smooth(32, 32))

    def broken(*a):
        raise RuntimeError("uvt_uastc_device_fit launch failed")

    monkeypatch.setattr(TC, "device_fit", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        T.encode_uastc_blocks(px, device_fit=True, device="cpu")
    monkeypatch.setattr(J, "_device_fit_fn", lambda modes: broken)
    with pytest.warns(RuntimeWarning, match="falling back"):
        J.encode_uastc_blocks(px, device=True)


def test_the_device_fit_needs_the_card_unless_told_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    px = J.image_to_blocks_rgba(_smooth(16, 16))
    with pytest.raises(RuntimeError, match="cuda"):
        T.encode_uastc_blocks(px, device_fit=True)
    # the host fit needs no device
    np.testing.assert_array_equal(T.encode_uastc_blocks(px, device_fit=False),
                                  J.encode_uastc_blocks(px, device=False))


@pytest.mark.parametrize("quality", [0, 1, 2])
@pytest.mark.parametrize("alpha", [False, True])
def test_legacy_ktx2_with_the_device_fit_matches(quality, alpha):
    imgs = np.stack([_smooth(32, 48, alpha), np.roll(_smooth(32, 48, alpha), 5, 1)])
    want = J.encode_uastc_ktx2(imgs, wire="legacy", device=True, quality=quality)
    got = T.encode_uastc_ktx2(imgs, wire="legacy", device_fit=True, device="cpu",
                              quality=quality)
    assert got == want


def test_device_fit_and_host_fit_agree_on_smooth_images():
    """The reference's own check (tests/test_uastc.py): on smooth content
    the device fit writes the host fit's bytes; so does the port's."""
    for im in (_smooth(128, 128), _smooth(128, 128, alpha=True)):
        px = T.image_to_blocks_rgba(im)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            np.testing.assert_array_equal(T.encode_uastc_blocks(px, device_fit=False),
                                          T.encode_uastc_blocks(px, device_fit=True, device="cpu"))
