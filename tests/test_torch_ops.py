"""The port's mesh and point-cloud ops against the JAX package (CPU).

The same seeded numpy inputs go through the reference's function (eager,
as its own tests call it) and the port's (its plain twins on the CPU).

Tolerances:
  - exact: Morton words, keys and permutations (duplicates included),
    `invert_permutation`, `quantize_step`, `dequantize_step`, octahedral
    (s, t), parallelogram encode and decode (forward and out-of-range
    indices, both `first_delta`), the Vandermonde matrix of the
    trajectory fit;
  - 0 ulps (bit for bit) on these inputs: octahedral decode and
    `estimate_normals`, whose float rules the port mirrors (XLA's FMAs,
    sum order and norm);
  - 1 ulp: `xla_cbrt` (XLA's float32 pow is one ulp off the rounded
    float64 power on ~0.07% of inputs), so `corto_quantization_step`
    within 2 ulps;
  - `_vty`: within 2 * F * eps32 * sum_k |V_k y_k| of XLA's product (float32
    sums of F terms taken in another order); trajectory coefficients and
    samples within the bound that error gives after the float64 solve
    (stated in each test).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvol_tpu_torch import _device
from uvol_tpu_torch.models import trajectory as ttraj
from uvol_tpu_torch.ops import mesh_cuda
from uvol_tpu_torch.ops import morton as tmorton
from uvol_tpu_torch.ops import normals as tnormals
from uvol_tpu_torch.ops import prediction as tpred

tq = importlib.import_module("uvol_tpu_torch.ops.quantize")
jmorton = importlib.import_module("uvol_tpu.ops.morton")
jnormals = importlib.import_module("uvol_tpu.ops.normals")
jpred = importlib.import_module("uvol_tpu.ops.prediction")
jq = importlib.import_module("uvol_tpu.ops.quantize")
jtraj = importlib.import_module("uvol_tpu.models.trajectory")


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulps(a, b) -> np.ndarray:
    """|a - b| in float32 ulps (ordered bit patterns)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


# ---- Morton ----------------------------------------------------------------


def _coords(seed, shape, bits, dup=False):
    r = np.random.default_rng(seed)
    hi = 64 if dup else 1 << bits
    return r.integers(0, hi, (*shape, 3)).astype(np.int32)


@pytest.mark.parametrize("seed,shape,bits,dup", [
    (0, (16,), 10, False), (1, (400,), 21, False), (2, (3, 500), 21, True),
    (3, (2, 1), 21, False), (4, (26145 // 16,), 11, True)])
def test_morton_words_match(seed, shape, bits, dup):
    q = _coords(seed, shape, bits, dup)
    np.testing.assert_array_equal(tmorton.morton30(_t(q & 0x3FF)).numpy(),
                                  np.asarray(jmorton.morton30(jnp.asarray(q & 0x3FF))))
    for tw, jw in zip(tmorton.morton63(_t(q)), jmorton.morton63(jnp.asarray(q)), strict=True):
        np.testing.assert_array_equal(tw.numpy().astype(np.int64),
                                      np.asarray(jw).astype(np.int64))


@pytest.mark.parametrize("seed,shape,bits,dup", [
    (0, (16,), 10, False), (1, (400,), 21, False), (2, (3, 500), 21, True),
    (3, (2, 1), 21, False), (5, (2, 2000), 3, True), (6, (4096,), 21, True)])
def test_morton_order_and_inverse_match(seed, shape, bits, dup):
    """Permutations identical, ties (duplicate coordinates) in index order;
    the int64 key orders as the reference's (top, mid, lo)."""
    q = _coords(seed, shape, bits, dup)
    perm = tmorton.morton_order(_t(q))
    jperm = jmorton.morton_order(jnp.asarray(q))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tmorton.invert_permutation(perm).numpy(),
                                  np.asarray(jmorton.invert_permutation(jperm)))
    key = tmorton.morton_key(_t(q)).numpy()
    top, mid, lo = (np.asarray(w).astype(np.int64) for w in jmorton.morton63(jnp.asarray(q)))
    np.testing.assert_array_equal(key, (top << 60) | (mid << 30) | lo)


def test_morton_key_extreme_coords():
    """Coordinates 0 and 2^21 - 1 on each axis: the key's top bits."""
    q = np.array([[0, 0, 0], [(1 << 21) - 1] * 3, [1 << 20, 0, 0], [0, 0, 1 << 20],
                  [(1 << 21) - 1, 0, 0]], np.int32)
    perm = tmorton.morton_order(_t(q)).numpy()
    np.testing.assert_array_equal(perm, np.asarray(jmorton.morton_order(jnp.asarray(q))))
    assert int(tmorton.morton_key(_t(q)).max()) == (1 << 63) - 1


# ---- the Morton keys of the point-cloud stage (U4's twin) ---------------------


@pytest.mark.parametrize("bits", [1, 11, 21])
def test_morton_keys_plain_is_quantize_then_key(bits):
    """U4's twin is the port's `quantize` (the same float32 ops) followed by
    `morton_key`, on every point."""
    r = np.random.default_rng(bits)
    x = (r.normal(size=(3, 700, 3)) * 40).astype(np.float32)
    x[1, :350] = x[1, 350:]  # duplicate points
    xt = _t(x)
    q = tq.quantize(xt, bits)
    inv = _device.true_div(1.0, _device.true_div(q.range_value, (1 << bits) - 1))
    got = mesh_cuda.morton_keys(xt, q.min_value, inv, bits)
    np.testing.assert_array_equal(got.numpy(), tmorton.morton_key(q.values).numpy())


def test_morton_keys_refuses_bits():
    x = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError):
        mesh_cuda.morton_keys(x, torch.zeros((1, 3)), torch.ones(1), 22)


# ---- Corto steps -------------------------------------------------------------


def test_xla_cbrt_within_one_ulp():
    """jnp.cbrt is copysign(pow(|x|, f32(1/3)), x) on XLA's CPU; the port
    takes the power in float64: <= 1 ulp, and equal on >= 99.8% of the
    integers 1 .. 2^16 and of their negatives."""
    n = np.arange(1, 1 << 16, dtype=np.float32)
    n = np.concatenate([n, -n, np.float32([0.0, -0.0])])
    want = np.asarray(jnp.cbrt(jnp.asarray(n)))
    got = tq.xla_cbrt(_t(n)).numpy()
    d = _ulps(got, want)
    assert d.max() <= 1
    assert (d == 0).mean() >= 0.998


@pytest.mark.parametrize("nvert,level", [(1, 0), (500, 0), (26145, 0), (26145, 2),
                                         (1 << 20, -1), (7, 3)])
def test_corto_quantization_step_within_two_ulps(nvert, level):
    r = np.random.default_rng(nvert + level)
    x = (r.normal(size=(4, 300, 3)) * r.uniform(0.1, 100, (4, 1, 3))).astype(np.float32)
    want = np.asarray(jq.corto_quantization_step(jnp.asarray(x), nvert, level))
    got = tq.corto_quantization_step(_t(x), nvert, level).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _ulps(got, want).max() <= 2


def test_quantize_step_and_dequantize_step_exact():
    """round(x / step) halves to even, as jnp.round does: x = odd * step/2
    sits on every half."""
    r = np.random.default_rng(7)
    step = np.float32([0.5, 2.0, 1e-3, 0.37])
    x = (r.normal(size=(4, 500, 3)) * 50).astype(np.float32)
    x[0, :40, 0] = (np.arange(-20, 20) * 2 + 1) * np.float32(0.25)  # k + 0.5 steps
    x[1, :40, 1] = np.arange(-20, 20) * 2 + 1.0
    want = np.asarray(jq.quantize_step(jnp.asarray(x), jnp.asarray(step)))
    got = tq.quantize_step(_t(x), _t(step))
    np.testing.assert_array_equal(got.numpy(), want)
    assert _bits_equal(tq.dequantize_step(got, _t(step)).numpy(),
                       np.asarray(jq.dequantize_step(jnp.asarray(want), jnp.asarray(step))))


# ---- octahedral normals --------------------------------------------------------


def _normals(seed, n=4000):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3)).astype(np.float32)
    v[:6] = [[1, 0, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1], [0, 0, 0], [-0.0, 0.0, -0.0]]
    v[6:12] = v[6:12] * np.float32(1e-30)  # tiny
    return v


@pytest.mark.parametrize("qbits", [6, 8, 10, 12, 16])
def test_octahedral_encode_exact_and_decode_bit_for_bit(qbits):
    v = _normals(qbits)
    st = tnormals.octahedral_encode(_t(v), qbits)
    jst = jnormals.octahedral_encode(jnp.asarray(v), qbits)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    r = np.random.default_rng(qbits)
    grid = r.integers(0, (1 << qbits) - 1, (5000, 2)).astype(np.int32)
    grid[:4] = [[0, 0], [(1 << qbits) - 2] * 2, [((1 << qbits) - 2) // 2] * 2, [0, 1]]
    for s in (grid, st.numpy()):
        got = tnormals.octahedral_decode(_t(s), qbits).numpy()
        want = np.asarray(jnormals.octahedral_decode(jnp.asarray(s), qbits))
        assert _bits_equal(got, want), _ulps(got, want).max()


# ---- estimate_normals (U3's twin) ------------------------------------------------


def _grid_mesh(ny, nx, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:ny, 0:nx]
    pos = np.stack([xx, yy, r.normal(size=(ny, nx))], -1).reshape(-1, 3).astype(np.float32)
    pos += r.normal(size=pos.shape).astype(np.float32) * 0.1
    faces = []
    for y in range(ny - 1):
        for x in range(nx - 1):
            i = y * nx + x
            faces += [[i, i + 1, i + nx], [i + 1, i + nx + 1, i + nx]]
    return pos, np.asarray(faces, np.int32)


def _normals_case(case):
    r = np.random.default_rng(11)
    if case == "grid":
        return _grid_mesh(9, 13, 0)
    if case == "padded_isolated_degenerate":
        pos, faces = _grid_mesh(6, 7, 1)
        pos = np.concatenate([pos, r.normal(size=(5, 3)).astype(np.float32)])  # isolated
        faces = np.concatenate([faces, [[-1, -1, -1]] * 4, [[3, 3, 3], [2, 4, 2],
                                                            [0, 1, 1]]]).astype(np.int32)
        return pos, faces
    if case == "fan_1000":  # one vertex shared by 1,000 faces, random positions
        pos = r.normal(size=(1002, 3)).astype(np.float32) * 100
        faces = np.stack([np.zeros(1000), np.arange(1, 1001), np.arange(2, 1002)], 1)
        faces = faces.astype(np.int32)
        faces[::3] = faces[::3][:, [1, 0, 2]]  # vertex 0 in every corner position
        faces[1::3] = faces[1::3][:, [1, 2, 0]]
        return pos, faces
    if case == "out_of_range":  # indices >= N gather row N - 1, scatter nothing
        pos, faces = _grid_mesh(4, 5, 2)
        faces = np.concatenate([faces, [[1, 2, 25], [30, 0, 1], [7, -3, 9]]]).astype(np.int32)
        return pos, faces
    if case == "random_faces":  # many shared vertices, sums in order
        pos = r.normal(size=(50, 3)).astype(np.float32) * 10
        return pos, r.integers(0, 50, (2000, 3)).astype(np.int32)
    if case == "no_faces":
        return r.normal(size=(7, 3)).astype(np.float32), np.zeros((0, 3), np.int32)
    raise ValueError(case)


NORMAL_CASES = ["grid", "padded_isolated_degenerate", "fan_1000", "out_of_range",
                "random_faces", "no_faces"]


@pytest.mark.parametrize("case", NORMAL_CASES)
def test_estimate_normals_bit_for_bit(case):
    pos, faces = _normals_case(case)
    got = tnormals.estimate_normals(_t(pos), _t(faces)).numpy()
    want = np.asarray(jnormals.estimate_normals(jnp.asarray(pos), jnp.asarray(faces)))
    assert _bits_equal(got, want), _ulps(got, want).max()


def test_estimate_normals_minus_one_rows_add_zero_to_vertex_zero():
    """A -1 row becomes vertex 0 times 0.0: with an infinite position 0
    the product is NaN, as in the reference."""
    pos = np.array([[np.inf, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    faces = np.array([[-1, -1, -1]], np.int32)
    got = tnormals.estimate_normals(_t(pos), _t(faces)).numpy()
    want = np.asarray(jnormals.estimate_normals(jnp.asarray(pos), jnp.asarray(faces)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert _bits_equal(np.nan_to_num(got), np.nan_to_num(want))


def test_normals_csr_order():
    """Each vertex's faces in (corner, face) order; corners past N dropped."""
    faces = torch.tensor([[0, 1, 2], [2, 0, 5], [1, 2, 0], [-1, -1, -1]], dtype=torch.int32)
    row, face_of = mesh_cuda.normals_csr(faces, 3)
    order = [(k, f) for k in range(3) for f in range(4)]
    vert = [max(int(faces[f, k]), 0) for k, f in order]
    want = [f for v in range(3) for (k, f), w in zip(order, vert) if w == v]
    assert row.tolist() == [0, 6, 8, 11] and face_of[:11].tolist() == want


# ---- parallelogram prediction ----------------------------------------------------


def _pidx(r, n, shape=()):
    i = np.arange(n)
    a = np.where(r.random((*shape, n)) < 0.2, -1, (i - r.integers(1, 4, (*shape, n))))
    b = i - r.integers(1, 6, (*shape, n))
    c = i - r.integers(1, 6, (*shape, n))
    p = np.stack([a, b, c], -1)
    p[..., 0, 0] = -1
    return p.astype(np.int32)


def _chain_case(case):
    r = np.random.default_rng(3)
    if case == "grid_pos":
        ny, nx = 9, 11
        n = ny * nx
        v = r.integers(0, 2048, (2, n, 3)).astype(np.int32)
        i = np.arange(n)
        ok = (i >= nx) & (i % nx >= 1)
        p = np.where(ok[:, None], np.stack([i - 1, i - nx, i - nx - 1], 1), -1)
        return v, np.broadcast_to(p, (2, n, 3)).astype(np.int32).copy()
    if case == "random_d1":
        return r.integers(-100, 100, (300, 1)).astype(np.int32), _pidx(r, 300)
    if case == "batched_d4":
        return (r.integers(-(1 << 20), 1 << 20, (2, 3, 200, 4)).astype(np.int32),
                _pidx(r, 200, (2, 3)))
    if case == "forward_refs":  # a, b, c at or after i read the zero-filled prefix
        n = 120
        p = _pidx(r, n)
        p[5:40, 0] = np.arange(5, 40) + r.integers(0, 30, 35)
        p[40:60, 1:] = np.arange(40, 60)[:, None] + 3
        p[60, :] = [60, 60, 60]
        return r.integers(-50, 50, (n, 2)).astype(np.int32), p
    if case == "minus_one_any_bc":  # a = -1 with any b and c, and negative b, c
        n = 90
        p = _pidx(r, n)
        p[::4, 0] = -1
        p[::4, 1:] = r.integers(-5, 200, (len(p[::4]), 2))
        p[1::7, 1:] = -7
        return r.integers(-9, 9, (n, 3)).astype(np.int32), p
    if case == "ends_and_wrap":  # indices 0 and N - 1, values near +-2^31
        n = 64
        p = _pidx(r, n)
        p[10:20, 0] = 0
        p[20:30, 1] = n - 1
        p[30:35, 2] = 0
        v = r.integers(-(1 << 31), (1 << 31) - 1, (n, 3), dtype=np.int64).astype(np.int32)
        v[:8] = [[(1 << 31) - 1] * 3, [-(1 << 31)] * 3] * 4
        return v, p
    if case == "one_vertex":
        return np.array([[7, -3]], np.int32), np.array([[-1, 0, 0]], np.int32)
    raise ValueError(case)


CHAIN_CASES = ["grid_pos", "random_d1", "batched_d4", "forward_refs", "minus_one_any_bc",
               "ends_and_wrap", "one_vertex"]


@pytest.mark.parametrize("first_delta", [True, False])
@pytest.mark.parametrize("case", CHAIN_CASES)
def test_parallelogram_encode_decode_exact(case, first_delta):
    v, p = _chain_case(case)
    res = tpred.parallelogram_encode(_t(v), _t(p), first_delta=first_delta)
    jres = jpred.parallelogram_encode(jnp.asarray(v), jnp.asarray(p), first_delta=first_delta)
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    back = tpred.parallelogram_decode(res, _t(p), first_delta=first_delta)
    jback = jpred.parallelogram_decode(jres, jnp.asarray(p), first_delta=first_delta)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    if case not in ("forward_refs", "ends_and_wrap"):  # no index at or after its vertex:
        # elsewhere the decode reads zeros where the encode read values
        np.testing.assert_array_equal(back.numpy(), v)


@pytest.mark.parametrize("first_delta", [True, False])
def test_parallelogram_out_of_range_indices(first_delta):
    """An index >= N: the encode's take_along_axis reads the int32 minimum,
    the decode's scan gathers row N - 1 of the prefix (XLA clamps). The
    port mirrors both."""
    r = np.random.default_rng(5)
    n = 40
    v = r.integers(-1000, 1000, (n, 3)).astype(np.int32)
    p = _pidx(r, n)
    p[10, 0], p[11, 1], p[12, 2], p[13] = n + 3, n, 10 ** 6, [n, n, n]
    res = tpred.parallelogram_encode(_t(v), _t(p), first_delta=first_delta)
    jres = jpred.parallelogram_encode(jnp.asarray(v), jnp.asarray(p), first_delta=first_delta)
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    rr = r.integers(-50, 50, (n, 3)).astype(np.int32)
    back = tpred.parallelogram_decode(_t(rr), _t(p), first_delta=first_delta)
    jback = jpred.parallelogram_decode(jnp.asarray(rr), jnp.asarray(p), first_delta=first_delta)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


def test_parallelogram_decode_jitted_reference():
    """The jitted, batched reference decode gives the same values."""
    v, p = _chain_case("batched_d4")
    res = jpred.parallelogram_encode(jnp.asarray(v), jnp.asarray(p))
    jback = jax.jit(jpred.parallelogram_decode)(res, jnp.asarray(p))
    back = tpred.parallelogram_decode(_t(np.asarray(res)), _t(p))
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


@pytest.mark.parametrize("shape", [(54017, 2), (65537, 3, 1)])
def test_parallelogram_decode_past_the_card_launch_limits(shape):
    """A chain of 54,017 vertices (one past the card's shared-memory
    prefix) and 65,537 frames (past one launch's grid): the twin, which
    the card is held to, equals the reference's jitted scan."""
    r = np.random.default_rng(len(shape))
    *batch, n, d = shape
    p = _pidx(r, n, tuple(batch))
    p[..., n // 2, :] = [n - 1, n - 1, n // 2 + 7]  # forward references read 0
    res = r.integers(-(1 << 20), 1 << 20, shape).astype(np.int32)
    want = jax.jit(jpred.parallelogram_decode)(jnp.asarray(res), jnp.asarray(p))
    got = tpred.parallelogram_decode(_t(res), _t(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- trajectory fit (U6) ---------------------------------------------------------


@pytest.mark.parametrize("f", [1, 2, 3, 5, 12, 20, 32, 97, 300])
def test_vandermonde_bit_for_bit(f):
    """jnp.linspace in float32 and lax.integer_pow's products, exactly."""
    degree = min(5, max(f - 1, 0))
    t = jnp.linspace(0.0, 1.0, f)
    want = np.asarray(jnp.stack([t**k for k in range(degree + 1)], axis=1))
    got = ttraj.vandermonde(f, degree, torch.device("cpu")).numpy()
    assert _bits_equal(got, want)


@pytest.mark.parametrize("f,n,degree", [(32, 300, 4), (12, 50, 3), (3, 40, 4), (7, 1, 2)])
def test_vty_within_summation_bound(f, n, degree):
    """XLA's and PyTorch's float32 products of F terms differ only in the
    order of the sums: |port - jax| <= 2 * F * eps32 * sum_k |V_k y_k|."""
    r = np.random.default_rng(f)
    pos = (r.normal(size=(f, n, 3)) * 10 + 100).astype(np.float32)
    degree = min(degree, f - 1)
    want = np.asarray(jtraj._vty_jit(jnp.asarray(pos), degree), np.float64)
    got = ttraj._vty(_t(pos), degree).numpy().astype(np.float64)
    vand = ttraj.vandermonde(f, degree, torch.device("cpu")).numpy().astype(np.float64)
    mag = np.abs(vand).T @ np.abs(pos.reshape(f, -1).astype(np.float64))
    assert np.all(np.abs(got - want) <= 2 * f * np.finfo(np.float32).eps * mag)


@pytest.mark.parametrize("f,degree", [(32, 4), (12, 3), (3, 4), (1, 4)])
def test_fit_trajectories_matches(f, degree):
    """Coefficients within 1e-4 of the reference's (relative to their
    scale) and samples within 1e-4 of its samples (relative to the
    positions' scale): the float64 solve amplifies V^T y's float32 order
    differences by V^T V's condition (~1e5 at degree 4, F = 32)."""
    r = np.random.default_rng(f)
    base = r.normal(size=(1, 200, 3)) * 5
    t = np.linspace(0, 1, f)[:, None, None]
    pos = (base + 0.3 * t**2 + 0.1 * t * base + 0.01 * r.normal(size=(f, 200, 3)))
    pos = pos.astype(np.float32)
    g = ttraj.fit_trajectories(pos, degree, device="cpu")
    jg = jtraj.fit_trajectories(pos, degree)
    assert (g.degree, g.frame_count) == (jg.degree, jg.frame_count)
    assert g.coefficients.shape == jg.coefficients.shape
    assert g.coefficients.dtype == np.float32
    scale = float(np.abs(jg.coefficients).max())
    assert np.abs(g.coefficients - jg.coefficients).max() <= 1e-4 * scale
    pscale = float(np.abs(pos).max())
    for k in (0, f // 2, f - 1, 0.5 * (f - 1)):
        assert np.abs(g.sample(k) - jg.sample(k)).max() <= 1e-4 * pscale
    assert abs(ttraj.reconstruction_error(pos, g) - jtraj.reconstruction_error(pos, jg)) \
        <= 1e-4 * pscale


def test_group_fixed_topology_matches():
    counts = np.array([5, 5, 5, 7, 7, 5, 9, 9, 9, 9])
    assert ttraj.group_fixed_topology(counts) == jtraj.group_fixed_topology(counts)
    assert ttraj.group_fixed_topology(np.array([], int)) == jtraj.group_fixed_topology(
        np.array([], int))
