"""The arithmetic of U3 and U5 (`csrc/mesh_ops.cu`), on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against their plain twins there). What can be
checked here is that the decompositions they compute are the twins'
functions, bit for bit:

  - U3 (`csrc/mesh_ops.cu`, `estimate_normals`): the CSR built on the
    card (per-range count and scan, a fill in any corner order, each
    row's keys sorted by the register networks or, past 32 keys, by a
    warp in windows), against `normals_csr`'s rows and
    `estimate_normals_plain`;
  - U5 (`parallelogram_decode`): the staged chain (references final
    before the tile folded into g by the staging warps, ring offsets,
    values loaded ahead, m1 and m2 times the last two outputs), against
    `parallelogram_decode_plain`..

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
from uvol_tpu_torch.ops import mesh_cuda as mc


# ---- U3 and U5: the mesh ops' CSR build and the parallelogram chain ----------------

_MESH_SRC = (Path(mc.__file__).resolve().parents[1] / "csrc" / "mesh_ops.cu").read_text()


def _mesh_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _MESH_SRC).group(1))


U3_RANGE = _mesh_const("kRangeVertices")
U3_SHORT = _mesh_const("kShortRow")
U3_WINDOW = _mesh_const("kLongRowKeys")
U5_TILE = _mesh_const("kChainTile")
U5_GROUP = _mesh_const("kChainGroup")
U5_AHEAD = _mesh_const("kChainAhead")
U3_RADIX_BITS = _mesh_const("kRadixBits")
FACE_BITS = 30
KEY_END = 3 << FACE_BITS


def _bitonic(keys: np.ndarray) -> np.ndarray:
    """The kernels' ascending bitonic network (`sort_keys`, and the warp's
    sort of a long row's window) on a power-of-two array."""
    k = keys.copy()
    c = len(k)
    size = 2
    while size <= c:
        stride = size >> 1
        while stride > 0:
            for i in range(c):
                j = i ^ stride
                if j > i and (k[i] > k[j]) == ((i & size) == 0):
                    k[i], k[j] = k[j], k[i]
            stride >>= 1
        size <<= 1
    return k


def _radix_row(row: np.ndarray, face_bits: int, stats: dict) -> np.ndarray:
    """The warp's stable LSD radix sort of a row longer than the window
    (`add_radix_row`): U3_RADIX_BITS a pass over the face bits in use, then
    the corner (bits 30-31); each pass counts its digits, scans them, and
    moves the keys 32 at a time in row order to their digit's next slot
    plus their rank among the lower lanes of the same digit."""
    bins = 1 << U3_RADIX_BITS
    face_passes = -(-face_bits // U3_RADIX_BITS)
    src = row.copy()
    for p in range(face_passes + 1):
        shift = U3_RADIX_BITS * p if p < face_passes else FACE_BITS
        digit = (src >> shift) & (bins - 1)
        hist = np.bincount(digit, minlength=bins)
        nxt = np.cumsum(hist) - hist
        dst = np.full_like(src, -1)
        for i0 in range(0, len(src), 32):
            d = digit[i0:i0 + 32]
            for lane in range(len(d)):
                rank = int((d[:lane] == d[lane]).sum())
                dst[nxt[d[lane]] + rank] = src[i0 + lane]
            nxt += np.bincount(d, minlength=bins)
        assert (dst >= 0).all()
        src = dst
        stats["passes"] += 1
    return src


def _u3_model(faces: np.ndarray, n: int, rng: np.random.Generator, range_vertices: int = U3_RANGE,
              window: int = U3_WINDOW):
    """numpy model of U3's three kernels: the count and scan per range of
    `range_vertices` vertices, the fill in a shuffled corner order (slots
    base + atomicAdd(&local[v], 1)), then each row's keys in the order the
    normals kernel adds them: rows of at most kShortRow keys through the
    register network of 8 or 32, rows of at most `window` keys through the
    warp's window (padded to a power of two >= 32, bitonic), longer ones
    through the warp's radix sort (`_radix_row`). Returns (rows as key
    arrays in sum order, stats)."""
    m = len(faces)
    flat = faces.reshape(-1).astype(np.int64)
    vert = np.maximum(flat, 0)
    ranges = -(-n // range_vertices)
    local = np.zeros(n, np.int64)
    total = np.zeros(ranges, np.int64)
    for j in range(ranges):
        v0, v1 = j * range_vertices, min(n, (j + 1) * range_vertices)
        cnt = np.bincount(vert[(vert >= v0) & (vert < v1)] - v0, minlength=v1 - v0)
        local[v0:v1] = np.cumsum(cnt) - cnt
        total[j] = cnt.sum()
    base = np.cumsum(total) - total
    keys = np.full(3 * m, -1, np.int64)
    for e in rng.permutation(3 * m):
        v = vert[e]
        if v < n:
            f, k = divmod(int(e), 3)
            keys[base[v // range_vertices] + local[v]] = k << FACE_BITS | f
            local[v] += 1
    face_bits = 1 if m <= 1 else int(m - 1).bit_length()
    stats = {"ranges": ranges, "window_rows": 0, "radix_rows": 0, "passes": 0}
    rows = []
    for v in range(n):
        j = v // range_vertices
        start = base[j] if v == j * range_vertices else base[j] + local[v - 1]
        row = keys[start:base[j] + local[v]]
        assert (row >= 0).all()
        if len(row) <= U3_SHORT:
            c = 8 if len(row) <= 8 else U3_SHORT
            padded = np.concatenate([row, np.full(c - len(row), 0xFFFFFFFF, np.int64)])
            rows.append(_bitonic(padded)[:len(row)])
        elif len(row) <= window:
            stats["window_rows"] += 1
            p2 = 32
            while p2 < len(row):
                p2 <<= 1
            padded = np.concatenate([row, np.full(p2 - len(row), 0xFFFFFFFF, np.int64)])
            rows.append(_bitonic(padded)[:len(row)])
        else:
            stats["radix_rows"] += 1
            rows.append(_radix_row(row, face_bits, stats))
    return rows, stats


def _u3_cases():
    """(name, positions, faces): -1 rows, indices >= N, isolated vertices, a
    vertex in more than 32 faces (the long-row path), M = 1, M = 0."""
    from uvol_tpu_torch.codecs.draco.grid import grid_mesh

    r = np.random.default_rng(18)
    pos, _, _, faces = grid_mesh(7, 9, 0)
    yield ("minus_one_rows_isolated_degenerate",
           np.concatenate([pos, r.normal(size=(4, 3)).astype(np.float32)]),
           np.concatenate([faces, np.full((5, 3), -1), [[3, 3, 3], [2, 4, 2], [0, 1, 1]]]))
    yield ("vertex_in_100_faces", r.normal(size=(102, 3)).astype(np.float32) * 100,
           np.array([np.roll([0, j + 1, j + 2], j % 3) for j in range(100)]))
    yield ("out_of_range", r.normal(size=(40, 3)).astype(np.float32),
           np.concatenate([r.integers(-2, 50, (200, 3)), [[1, 10 ** 6, 2]]]))
    yield ("random_shared", r.normal(size=(12, 3)).astype(np.float32),
           r.integers(0, 12, (300, 3)))
    yield "one_face", r.normal(size=(5, 3)).astype(np.float32), np.array([[3, 1, 2]])
    yield "no_face", r.normal(size=(4, 3)).astype(np.float32), np.zeros((0, 3), np.int64)
    yield ("padding_on_vertex_0", r.normal(size=(20, 3)).astype(np.float32),
           np.concatenate([r.integers(0, 20, (30, 3)), np.full((80, 3), -1)]))
    p, _, _, fg = grid_mesh(11, 13, 2)
    yield "grid_11x13", p, fg


U3_CASES = {name: (p, f.astype(np.int32)) for name, p, f in _u3_cases()}


@pytest.mark.parametrize("range_vertices,window", [(U3_RANGE, U3_WINDOW), (16, 32), (7, 64)])
@pytest.mark.parametrize("case", list(U3_CASES))
def test_u3_csr_design_gives_normals_csr_rows(case, range_vertices, window):
    """The count/scan/fill in a shuffled corner order and the per-row sorts
    give `normals_csr`'s rows exactly, at the kernel's range and window and
    at small ones (several ranges, long rows split into windows)."""
    pos, faces = U3_CASES[case]
    n = len(pos)
    rows, stats = _u3_model(faces, n, np.random.default_rng(len(faces) + range_vertices),
                            range_vertices, window)
    row, face_of = mc.normals_csr(torch.from_numpy(faces), n)
    row, face_of = row.numpy(), face_of.numpy()
    for v in range(n):
        got = rows[v]
        assert list(got & ((1 << FACE_BITS) - 1)) == list(face_of[row[v]:row[v + 1]])
        assert (np.diff(got) > 0).all()  # (corner, face) ascending
    assert stats["ranges"] == -(-n // range_vertices)
    if case in ("vertex_in_100_faces", "random_shared", "padding_on_vertex_0"):
        assert stats["window_rows"] + stats["radix_rows"] >= 1
    if window < U3_WINDOW and case in ("vertex_in_100_faces", "padding_on_vertex_0"):
        assert stats["radix_rows"] >= 1


@pytest.mark.parametrize("m_extra", [0, 300, 70000])
@pytest.mark.parametrize("padding", [171, 1000, 5000])
def test_u3_long_row_radix_sort_gives_normals_csr_rows(padding, m_extra):
    """Vertex 0 under `padding` -1 rows (a row of 3 x padding keys and more,
    past the window from 171 on) and `m_extra` faces elsewhere (1 to 3 face
    digits): the radix passes give its row, and every other, exactly in
    (corner, face) order, one pass a face digit in use and one for the
    corner."""
    r = np.random.default_rng(padding + m_extra)
    n = 20
    faces = np.concatenate([r.integers(0, n, (30, 3)), np.full((padding, 3), -1),
                            r.integers(1, n, (m_extra, 3))]).astype(np.int32)
    rows, stats = _u3_model(faces, n, r, U3_RANGE, U3_WINDOW)
    row, face_of = mc.normals_csr(torch.from_numpy(faces), n)
    row, face_of = row.numpy(), face_of.numpy()
    for v in range(n):
        assert list(rows[v] & ((1 << FACE_BITS) - 1)) == list(face_of[row[v]:row[v + 1]])
        assert (np.diff(rows[v]) > 0).all()
    face_passes = -(-int(len(faces) - 1).bit_length() // U3_RADIX_BITS)
    assert stats["radix_rows"] >= 1
    assert stats["passes"] == stats["radix_rows"] * (face_passes + 1)


@pytest.mark.parametrize("case", list(U3_CASES))
def test_u3_design_sums_equal_estimate_normals_plain(case):
    """The model's rows added in order from 0.0 (float32, the face normals of
    `face_normals_plain`) and normalised equal the twin bit for bit."""
    pos, faces = U3_CASES[case]
    n = len(pos)
    rows, _ = _u3_model(faces, n, np.random.default_rng(3), 16, 32)
    fn = mc.face_normals_plain(torch.from_numpy(pos), torch.from_numpy(faces)).numpy()
    sums = np.zeros((n, 3), np.float32)
    for v in range(n):
        for key in rows[v]:
            sums[v] = sums[v] + fn[key & ((1 << FACE_BITS) - 1)]
    t = torch.from_numpy(sums)
    norm = mc.xla_norm3(t)[:, None]
    got = mc.true_div(t, torch.where(norm > 0, norm, torch.ones_like(norm)))
    want = mc.estimate_normals_plain(torch.from_numpy(pos), torch.from_numpy(faces))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("c", [8, 32])
def test_u3_register_network_sorts_any_row(c):
    """The register network of 8 and of 32 sorts every length up to c, the
    padding (0xFFFFFFFF) last, keys near 3 << 30 included."""
    r = np.random.default_rng(c)
    for length in range(c + 1):
        for _ in range(3):
            row = r.choice(KEY_END, length, replace=False).astype(np.int64)
            padded = np.concatenate([row, np.full(c - length, 0xFFFFFFFF, np.int64)])
            assert list(_bitonic(padded)[:length]) == sorted(row)


def _u5_twin(res: np.ndarray, pidx: np.ndarray) -> np.ndarray:
    return mc.parallelogram_decode_plain(torch.from_numpy(res), torch.from_numpy(pidx)).numpy()


def _u5_model(res: np.ndarray, pidx: np.ndarray, rng: np.random.Generator, tile: int = U5_TILE,
              ahead: int = U5_AHEAD, group: int = U5_GROUP, helpers_first: bool = True):
    """numpy model of parallelogram_decode_kernel, uint32 arithmetic: per
    frame and group of up to `group` components (a full-group launch, then
    one for the rest), tiles of `tile` steps; the helpers stage tile t + 1
    (g = res + the references final before tile t began: the ring for tile
    t - 1, `out` before it; m1 and m2 for references to i - 1 and i - 2;
    ring offsets for the rest, which mark the tile as one that reads the
    ring) and store tile t - 1 from the ring, before (`helpers_first`) or
    after the stepping lanes run tile t; the lanes load each step's values
    `ahead` steps early (once the step `ahead` back is stored; at the
    tile's start for its first steps; a tile that reads no ring value
    loads none) and compute g + r_a + r_b - r_c + m2 * out_{i-2} + m1 *
    out_{i-1}. The ring and `out` start as garbage, and a ring value
    loaded before its step stored it fails the model. Returns (out,
    stats)."""
    f, n, d = res.shape
    last = n - 1
    mask = 2 * tile - 1
    zero = 2 * tile
    out = rng.integers(0, 1 << 32, (f, n, d), dtype=np.uint64).astype(np.uint32)
    r32 = res.astype(np.uint32)
    stats = {"tiles": -(-n // tile), "ring_refs": 0, "g_from_ring": 0, "g_from_out": 0,
             "carry": 0, "carry2": 0, "free_tiles": 0, "groups": []}
    whole = d // group if d > group else 0
    groups = ([(q * group, group) for q in range(whole)] + ([(whole * group, d - whole * group)]
              if d - whole * group else [])) if d > group else [(0, d)]
    stats["groups"] = groups
    for fr in range(f):
        ix = pidx[fr].astype(np.int64)
        for c0, dg in groups:
            cols = slice(c0, c0 + dg)
            ring = rng.integers(0, 1 << 32, (2 * tile + 1, dg), dtype=np.uint64).astype(np.uint32)
            ring[zero] = 0
            rec = [[None] * tile, [None] * tile]
            gbuf = np.zeros((2, tile, dg), np.uint32)
            ringy = [0, 0]
            tiles = -(-n // tile)

            def stage(tau):
                s0, buf = tau * tile, tau & 1
                young, ringed = s0 - tile, s0 - 2 * tile
                for j in range(min(tile, n - s0)):
                    s = s0 + j
                    a, b, c = ix[s]
                    acc = r32[fr, s, cols].copy()
                    m1, m2, off = 1, 0, [zero, zero, zero]
                    if a >= 0:
                        m1 = 0
                        for k, x in enumerate((min(a, last), min(max(b, 0), last),
                                               min(max(c, 0), last))):
                            if x >= s:
                                continue
                            if x == s - 1:
                                m1 += -1 if k == 2 else 1
                                stats["carry"] += 1
                            elif x == s - 2:
                                m2 += -1 if k == 2 else 1
                                stats["carry2"] += 1
                            elif x < young:
                                if x >= ringed:
                                    v = ring[x & mask]
                                    stats["g_from_ring"] += 1
                                else:
                                    v = out[fr, x, cols]
                                    stats["g_from_out"] += 1
                                acc = acc - v if k == 2 else acc + v
                            else:
                                off[k] = x & mask
                                stats["ring_refs"] += 1
                                ringy[buf] = tau + 1
                                assert x <= s - ahead, "a ring value loaded before its store"
                    gbuf[buf, j] = acc
                    rec[buf][j] = (off, m1, m2)

            def store(tau):
                s0 = tau * tile
                for j in range(min(tile, n - s0)):
                    out[fr, s0 + j, cols] = ring[(s0 + j) & mask]

            def step(t, prev1, prev2):
                s0, buf = t * tile, t & 1
                length = min(tile, n - s0)
                ringed = ringy[buf] == t + 1
                stats["free_tiles"] += not ringed
                pre = {}
                for u in range(min(ahead, length)):  # the tile's prologue
                    pre[u] = [ring[o].copy() for o in rec[buf][u][0]]
                for j in range(length):
                    _off, m1, m2 = rec[buf][j]
                    va, vb, vc = pre.pop(j)
                    v = gbuf[buf, j] + (va + vb - vc if ringed else 0)
                    y = (np.uint32(m1 & 0xFFFFFFFF) * prev1
                         + (np.uint32(m2 & 0xFFFFFFFF) * prev2 + v))
                    prev1, prev2 = y, prev1
                    ring[(s0 + j) & mask] = y
                    if j + ahead < length:
                        pre[j + ahead] = [ring[o].copy() for o in rec[buf][j + ahead][0]]
                return prev1, prev2

            stage(0)
            prev = (np.zeros(dg, np.uint32), np.zeros(dg, np.uint32))
            for t in range(tiles):
                helpers = [lambda t=t: stage(t + 1) if t + 1 < tiles else None,
                           lambda t=t: store(t - 1) if t >= 1 else None]
                if helpers_first:
                    for h in helpers:
                        h()
                    prev = step(t, *prev)
                else:
                    prev = step(t, *prev)
                    for h in helpers[::-1]:
                        h()
            store(tiles - 1)
    return out.view(np.int32), stats


def _u5_grid(ny: int, nx: int) -> np.ndarray:
    i = np.arange(ny * nx)
    inner = (i >= nx) & (i % nx >= 1)
    return np.where(inner[:, None], np.stack([i - 1, i - nx, i - nx - 1], 1), -1)


def _u5_refs(kind: str, f: int, n: int, r: np.random.Generator) -> np.ndarray:
    """Index triples [f, n, 3] int32 of one kind of chain."""
    i = np.arange(n)
    if kind == "grid":
        nx = max(2, int(np.sqrt(n)) + 3)
        p = np.broadcast_to(_u5_grid(-(-n // nx), nx)[:n], (f, n, 3))
    elif kind == "random":  # as chip_smoke.u5_chain: mostly i - 1, far references
        a = np.where(r.random((f, n)) < 0.6, i - 1, i - r.integers(1, 1 << 16, (f, n)))
        a = np.where(r.random((f, n)) < 0.05, -1, np.where(r.random((f, n)) < 0.01, i + 3, a))
        b, c = i - r.integers(1, 1 << 12, (f, n)), i - r.integers(-2, 1 << 12, (f, n))
        p = np.stack([a, np.maximum(b, -1), c], -1)
    elif kind == "lags":  # exactly i - 1 .. i - 5, every pairing
        lag = r.integers(1, U5_AHEAD + 2, (f, n, 3))
        p = i[None, :, None] - lag
    elif kind == "near":  # forward, a = -1 rows, past N
        a = np.where(r.random((f, n)) < 0.2, -1, i - r.integers(-3, 5, (f, n)))
        b, c = i - r.integers(-2, 6, (f, n)), i + r.integers(-5, 40, (f, n))
        p = np.stack([a, b, c], -1)
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(p).astype(np.int32)


def _u5_residuals(f: int, n: int, d: int, r: np.random.Generator) -> np.ndarray:
    res = r.integers(-(1 << 31), (1 << 31) - 1, (f, n, d), dtype=np.int64)
    res[:, :2] = (1 << 31) - 1  # sums wrap at once
    return res.astype(np.int32)


U5_MODEL_CASES = [(kind, f, n, d) for kind in ("grid", "random", "lags", "near")
                  for f, n, d in ((2, 1, 1), (1, 7, 2), (2, 33, 3), (1, 100, 4), (1, 70, 5))]


@pytest.mark.parametrize("helpers_first", [True, False])
@pytest.mark.parametrize("kind,f,n,d", U5_MODEL_CASES)
def test_u5_chain_design_equals_the_twin(kind, f, n, d, helpers_first):
    """Tiles of 8-16 steps (tile seams every few steps), D 1-5 (a group of 4
    and one of 1 at D = 5), the helpers' work before or after the stepping
    lanes' tile: the model equals `parallelogram_decode_plain`."""
    r = np.random.default_rng(n * 7 + d)
    pidx, res = _u5_refs(kind, f, n, r), _u5_residuals(f, n, d, r)
    got, stats = _u5_model(res, pidx, r, tile=16, helpers_first=helpers_first)
    np.testing.assert_array_equal(got, _u5_twin(res, pidx))
    if kind == "lags" and n >= 33:
        assert stats["carry"] > 0 and stats["carry2"] > 0 and stats["ring_refs"] > 0
    if d == 5:
        assert stats["groups"] == [(0, 4), (4, 1)]


@pytest.mark.parametrize("kind", ["grid", "random", "lags", "near"])
@pytest.mark.parametrize("ahead", [1, 2, 3])
def test_u5_chain_design_at_other_distances(kind, ahead):
    """The same pipeline with values loaded 1, 2 or 3 steps ahead (at most
    3: references 1 and 2 steps back are the registers' m1 and m2, so a
    ring reference is at least 3 back; the model fails a load made sooner)."""
    r = np.random.default_rng(ahead)
    pidx, res = _u5_refs(kind, 1, 300, r), _u5_residuals(1, 300, 3, r)
    got, _ = _u5_model(res, pidx, r, tile=32, ahead=ahead)
    np.testing.assert_array_equal(got, _u5_twin(res, pidx))


@pytest.mark.parametrize("n", [54015, 54016, 54017])
def test_u5_chain_design_across_the_former_shared_limit(n):
    """The kernel's own tiles around 54,016 vertices, where the former design
    moved its prefix to device memory: references up to 2^16 back read
    `out` through the staging warps."""
    r = np.random.default_rng(n)
    pidx, res = _u5_refs("random", 1, n, r), _u5_residuals(1, n, 1, r)
    got, stats = _u5_model(res, pidx, r)
    np.testing.assert_array_equal(got, _u5_twin(res, pidx))
    assert stats["g_from_out"] > 0 and stats["g_from_ring"] > 0
    assert stats["tiles"] == -(-n // U5_TILE)


def test_u5_chain_design_on_the_grid_decodes_its_input():
    """The grid's parallelograms (a = i - 1, b and c 315 back) at the smoke's
    width: the model decodes what `parallelogram_encode` gave, and every
    tile is ring-free (b and c lie more than two tiles back, in g)."""
    from uvol_tpu_torch.ops.prediction import parallelogram_encode

    r = np.random.default_rng(5)
    pidx = np.ascontiguousarray(np.broadcast_to(_u5_grid(9, 315), (2, 9 * 315, 3))).astype(np.int32)
    v = r.integers(0, 2048, (2, 9 * 315, 3)).astype(np.int32)
    res = parallelogram_encode(torch.from_numpy(v), torch.from_numpy(pidx)).numpy()
    got, stats = _u5_model(res, pidx, r)
    np.testing.assert_array_equal(got, v)
    assert stats["carry2"] == 0 and stats["carry"] > 0 and stats["ring_refs"] == 0
    assert stats["free_tiles"] == 2 * stats["tiles"] * 1  # 2 frames, one group of 3


def test_u5_chain_launch_count():
    """One launch up to 4 components or a multiple of 4, else two."""
    assert [mc._chain_launches(3, d) for d in range(1, 10)] == [1, 1, 1, 1, 2, 2, 2, 1, 2]
