"""The arithmetic of K8 (`csrc/drc.cu`), on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against their plain twins there). What can be
checked here is that the decompositions they compute are the twins'
functions, bit for bit:

  - K8 (`csrc/drc.cu`, the `.drc` window's device stage): each CTA's first
    frame, offset and one-frame flag, its staged metadata, its bytes staged
    in 16-byte pieces from the boundary at or below its first byte (bytewise
    where a piece leaves the window), runs of whole groups with the
    component, vertex and frame carried, and the padded output offsets,
    against `fused_batch_plain`.

Every comparison here is exact: integers compared as integers, floats
compared bit for bit (`view(int32)`), no tolerance.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from torch_design_models import _bits
from uvol_tpu_torch.models import drc_device as dd


# ---- K8: the .drc window's unpack, dequantize and normals ---------------------------

_DRC_SRC = (Path(dd.__file__).resolve().parents[1] / "csrc" / "drc.cu").read_text()
K8_VALUES = int(re.search(r"constexpr int kValues = (\d+);", _DRC_SRC).group(1))
K8_META_CAP = int(re.search(r"constexpr int kMetaCap = (\d+);", _DRC_SRC).group(1))


def _k8_window(attrs, f: int, nmax: int, seed: int, lead: int = 0, pad: int = 0,
               maxv=(254.0, 0.0, -1.0)):
    """A packed window: `lead` bytes before its first attribute, then the
    attributes [(kind, mode, nc)] (signed values at both extremes in modes
    16 and 32), `pad` bytes, the metadata 4-aligned at its tail. Returns
    (packed uint8 array, specs, meta_off, meta_len)."""
    r = np.random.default_rng(seed)
    chunks, metas, specs = [np.full(lead, 0xA5, np.uint8)], [], []
    off, moff = lead, 0
    for t, (kind, mode, nc) in enumerate(attrs):
        n = f * nmax * nc
        hi = 1 << (mode - 1) if mode in (16, 32) else 1 << mode
        lo = -hi if mode in (16, 32) else 0
        ints = r.integers(lo, hi, n, dtype=np.int64)
        ints[:2] = (lo, hi - 1)[:min(n, 2)]
        meta = (np.concatenate([r.normal(size=f * nc) * 5, r.uniform(1e-4, 1e-2, f)])
                if kind == 1 else np.resize(np.asarray(maxv, np.float64), f))
        specs.append((t, kind, mode, f, nmax, nc, off, len(meta), moff))
        chunks.append(dd._pack_host(ints, mode))
        metas.append(meta.astype(np.float32))
        off += len(chunks[-1])
        moff += len(meta)
    pad += (-(off + pad)) % 4
    meta_all = np.concatenate(metas)
    packed = np.concatenate(chunks + [np.zeros(pad, np.uint8), meta_all.view(np.uint8)])
    return packed, tuple(specs), off + pad, len(meta_all)


def _k8_unpack(buf: np.ndarray, sb: np.ndarray, mode: int, run: int) -> np.ndarray:
    """[runs, run] values cut from the little-endian bit stream whose byte 0
    is buf[sb] (a run's words realigned by the kernel's funnel shifts)."""
    out = np.empty((len(sb), run), np.int64)
    for j in range(run):
        byte, shift = divmod(j * mode, 8)
        word = np.zeros(len(sb), np.uint64)
        for k in range(5):  # 40 bits hold any value's bits
            word |= buf[sb + byte + k].astype(np.uint64) << np.uint64(8 * k)
        v = (word >> np.uint64(shift)).astype(np.int64) & ((1 << mode) - 1)
        if mode in (16, 32):
            v = v - ((v >> (mode - 1)) << mode)
        out[:, j] = v
    return out


def _k8_model(packed: np.ndarray, specs, meta_off: int, base: int):
    """numpy model of drc_fused_batch_kernel on a window whose first byte
    lies `base` bytes past a 16-byte boundary: per CTA the first frame,
    offset and one-frame flag (64-bit), the staged metadata slice (or
    global past the cap), the bytes staged from the 16-byte boundary at or
    below the CTA's first byte (a piece wholly inside the window in one
    16-byte load, else its run's bytes one by one), then runs of 4 values
    (kind 1) or 4 vertices (kind 2) with the carried component, vertex and
    frame. Returns (outputs per spec, stats); asserts that no load leaves
    the window, that every output float is stored once and that each
    16-byte store is 16-byte aligned."""
    size = len(packed)
    meta = packed[meta_off:].view(np.float32)
    widths = [nc if kind == 1 else 3 for _t, kind, _m, _f, _n, nc, *_r in specs]
    offs, total = [], 0
    for (_t, _k, _m, f, nmax, *_r), w in zip(specs, widths):
        offs.append(total)
        total += -(-f * nmax * w // 4) * 4
    stores = np.zeros(total, np.int64)
    stats = {"vector_loads": 0, "byte_pieces": 0, "tail_byte_piece": False,
             "one_frame_ctas": 0, "crossing_ctas": 0, "staged": 0, "global": 0}
    jobs1, jobs2 = [], []  # (out index, q, scale, min), (out index, qu, qv, maxv)
    for (_t, kind, mode, f, nmax, nc, off, _ml, moff), oo in zip(specs, offs):
        n = f * nmax * nc
        m = meta[moff:]
        for v0 in range(0, n, K8_VALUES):
            nv = min(K8_VALUES, n - v0)
            # warp 0: frames and metadata
            per, u0, nu = (nmax * nc, v0, nv) if kind == 1 else (nmax, v0 // 2, nv // 2)
            fi0, fi1 = u0 // per, (u0 + nu - 1) // per
            nf = fi1 - fi0 + 1
            lo = m[fi0 * nc:(fi1 + 1) * nc] if kind == 1 else m[fi0:fi1 + 1]
            hi = m[f * nc + fi0:f * nc + fi1 + 1] if kind == 1 else np.zeros(0, np.float32)
            stats["staged" if len(lo) + len(hi) <= K8_META_CAP else "global"] += 1
            r0, one = u0 - fi0 * per, fi0 == fi1
            stats["one_frame_ctas" if one else "crossing_ctas"] += 1
            # staging
            b0 = off + v0 * mode // 8
            span = dd._packed_nbytes(nv, mode)
            first = base + b0
            head = first % 16
            pieces = (head + span + 15) // 16
            buf = np.full(pieces * 16 + 64, 0xCD, np.uint8)  # unstaged bytes: garbage
            for k in range(pieces):
                a = first - head + 16 * k - base  # window byte of the piece's first
                if a >= 0 and a + 16 <= size:
                    buf[16 * k:16 * k + 16] = packed[a:a + 16]
                    stats["vector_loads"] += 1
                else:
                    stats["byte_pieces"] += 1
                    stats["tail_byte_piece"] |= a + 16 > size
                    for b in range(16):
                        if b0 <= a + b < b0 + span:
                            assert 0 <= a + b < size
                            buf[16 * k + b] = packed[a + b]
            # runs
            run = 4 if kind == 1 else 8
            units = nv if kind == 1 else nv // 2  # values, or vertices
            lu = np.arange(0, units, 4)  # each run's first value (vertex), CTA-local
            valid = np.minimum(4, units - lu)
            q = _k8_unpack(buf, head + lu * (run // 4) * mode // 8, mode, run)
            rr, fl = r0 + lu, np.zeros(len(lu), np.int64)
            if not one:
                fv = nmax * nc if kind == 1 else nmax
                fl = rr // fv
                rr = rr - fl * fv
            if kind == 1:
                vert, c = rr // nc, rr % nc
                mi = fl * nc + c
            else:
                vert, c, mi = rr, 0, 0
            for j in range(4):
                live = j < valid
                if j > 0:  # carry: component (kind 1), vertex, frame
                    if kind == 1:
                        mi = mi + 1
                        c = c + 1
                        wrap = live & (c == nc)
                        c = np.where(wrap, 0, c)
                        mi = np.where(wrap, mi - nc, mi)
                        cross = wrap & (vert + 1 == nmax) & (not one)
                        vert = np.where(wrap, np.where(cross, 0, vert + 1), vert)
                        mi = np.where(cross, mi + nc, mi)
                    else:
                        cross = live & (vert + 1 == nmax) & (not one)
                        vert = np.where(cross, 0, vert + 1)
                    fl = np.where(cross, fl + 1, fl)
                at = lu[live] + j
                if kind == 1:
                    jobs1.append((oo + v0 + at, q[live, j], hi[fl[live]], lo[mi[live]]))
                else:
                    jobs2.append((oo + 3 * (u0 + at), q[live, 2 * j], q[live, 2 * j + 1],
                                  lo[fl[live]]))
            # stores: whole runs as 16-byte stores, the rest one float at a time
            w = 1 if kind == 1 else 3
            for start, ok in zip(oo + w * (u0 + lu), valid):
                stores[start:start + w * ok] += 1
                if ok == 4:
                    assert start % 4 == 0
    assert (stores <= 1).all()
    out = np.zeros(total, np.float32)
    if jobs1:
        at, q, scale, mn = (np.concatenate(x) for x in zip(*jobs1))
        out[at] = dd.dequantize(torch.from_numpy(q.reshape(-1, 1, 1)),
                                torch.from_numpy(mn.reshape(-1, 1)),
                                torch.from_numpy(scale)).numpy().reshape(-1)
    if jobs2:
        at, qu, qv, mv = (np.concatenate(x) for x in zip(*jobs2))
        st = torch.from_numpy(np.stack([qu, qv], -1).reshape(-1, 1, 2))
        nrm = dd.oct_to_unit(st, torch.from_numpy(mv)).numpy().reshape(-1, 3)
        for k in range(3):
            out[at + k] = nrm[:, k]
    outs = []
    for (_t, _k, _m, f, nmax, *_r), w, oo in zip(specs, widths, offs):
        assert (stores[oo:oo + f * nmax * w] == 1).all()  # each float stored once
        outs.append(out[oo:oo + f * nmax * w].reshape(f, nmax, w))
    return outs, offs, total, stats


def _hold_k8_model(packed, specs, mo, ml, base):
    got, offs, total, stats = _k8_model(packed, specs, mo, base)
    want = dd.fused_batch_plain(torch.from_numpy(packed), specs, mo, ml)
    for g, w in zip(got, want, strict=True):
        w = w.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(_bits(g[~np.isnan(g)]), _bits(w[~np.isnan(w)]))
    plan = dd._plan(specs, mo, ml)  # the wrapper's padded layout is the model's
    assert [at for _s, _st, at in plan.views] == offs and plan.total == total
    assert all(at % 4 == 0 for at in offs)
    return stats


K8_CASES = ([(1, mode, nc, nmax) for mode in (8, 10, 12, 16, 32) for nc in (1, 2, 3, 4)
             for nmax in (1, 3, 1001, 4096, 4097)]
            + [(2, mode, 2, nmax) for mode in (8, 10, 12, 16, 32)
               for nmax in (1, 3, 1001, 4096, 4097)])


@pytest.mark.parametrize("kind,mode,nc,nmax", K8_CASES)
def test_k8_design_equals_the_twin(kind, mode, nc, nmax):
    """Every mode and kind, nc 1-4, frames of 1, 3, 1,001, 4,096 and 4,097
    vertices (CTAs that cross frames: all but 4,096), the attribute at an
    odd residue mod 16 and the window off a 16-byte boundary."""
    lead = (mode * 7 + nc * 3 + nmax) % 16
    packed, specs, mo, ml = _k8_window([(kind, mode, nc)], 3, nmax, seed=lead + mode + nmax,
                                       lead=lead)
    base = (4 - mo) % 4 + 4 * (nmax % 4)  # the metadata stays 4-byte aligned
    stats = _hold_k8_model(packed, specs, mo, ml, base)
    fv = nmax * nc if kind == 1 else nmax
    assert stats["crossing_ctas"] == 0 or fv % (K8_VALUES if kind == 1 else K8_VALUES // 2)


@pytest.mark.parametrize("lead", range(16))
def test_k8_design_with_four_attributes_at_every_offset_residue(lead):
    """Four attributes in one window (the table's most), the first at each
    residue mod 16, the window at two bases; every CTA of the liam-scale
    bucket lies in one frame."""
    packed, specs, mo, ml = _k8_window([(1, 12, 3), (1, 10, 2), (2, 8, 2), (1, 16, 4)], 2, 4096,
                                       seed=lead, lead=lead, pad=lead % 4)
    for base in ((4 - mo) % 4, (4 - mo) % 4 + 8):
        stats = _hold_k8_model(packed, specs, mo, ml, base)
        assert stats["crossing_ctas"] == 0 and stats["global"] == 0


@pytest.mark.parametrize("base", range(0, 16, 4))
@pytest.mark.parametrize("nmax", [1001, 1003])
def test_k8_design_reads_nothing_past_a_window_that_ends_in_its_metadata(nmax, base):
    """Normals of one frame: 4 bytes of metadata after the attribute, so the
    16-byte piece of its last bytes reaches past the window for some bases
    and is read byte by byte there (the model asserts every load inside)."""
    packed, specs, mo, ml = _k8_window([(2, 8, 2)], 1, nmax, seed=nmax + base, maxv=(254.0,))
    stats = _hold_k8_model(packed, specs, mo, ml, base)
    end = base + dd._packed_nbytes(2 * nmax, 8)  # address just past the attribute
    assert stats["tail_byte_piece"] == (-(-end // 16) * 16 > base + len(packed))


def test_k8_design_stages_metadata_and_leaves_it_past_the_cap():
    """Frames of one vertex: a CTA touches hundreds of frames, whose mins
    and scales pass the staging cap; frames of 3 vertices fit under it."""
    packed, specs, mo, ml = _k8_window([(1, 12, 3)], 2048, 1, seed=1)
    assert _hold_k8_model(packed, specs, mo, ml, 0)["global"] > 0
    packed, specs, mo, ml = _k8_window([(1, 12, 3)], 700, 3, seed=2)
    stats = _hold_k8_model(packed, specs, mo, ml, 0)
    assert stats["global"] == 0 and stats["crossing_ctas"] > 0


def test_fused_batch_caches_its_plan_and_still_checks_each_window():
    """A cache hit returns the same plan; a window one byte short of a
    cached key still raises; the cache keeps at most PLANS_MAX keys."""
    packed, specs, mo, ml = _k8_window([(1, 12, 3), (2, 8, 2)], 2, 7, seed=3)
    t = torch.from_numpy(packed)
    first = dd.fused_batch(t, specs, mo, ml)
    assert dd._plan(specs, mo, ml) is dd._plan(list(specs), mo, ml)
    for g, w in zip(first, dd.fused_batch_plain(t, specs, mo, ml), strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    with pytest.raises(ValueError, match="outside a window"):
        dd.fused_batch(t[:-1], specs, mo, ml)
    short = (specs[0], specs[1][:6] + (len(packed),) + specs[1][7:])
    with pytest.raises(ValueError, match="outside a window"):
        dd.fused_batch(t, short, mo, ml)
    for k in range(dd.PLANS_MAX + 5):
        dd._plan(specs, mo + 4 * k, ml)
    assert len(dd._PLANS) == dd.PLANS_MAX
