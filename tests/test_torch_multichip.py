"""The port's multi-device paths on spawned gloo groups of 2 and 4 CPU
ranks, against the JAX package on its 8 virtual CPU devices.

One group of each size runs `rank_job` once per module: the sharded
geometry and texture codecs (frame counts that divide the mesh and the
ragged 6 frames over 4 and 5 layers over 2 and 4), `encode_bucketed`
with the mesh, `from_jax_codec` with a mesh, the ETC1S palette build and
segment encode, the indivisible block count's fallback, and the codebook
training step. The checks are parametrised over those results.

Tolerances: wire bytes, ETC1S palettes and assignments, the codebook of
a training step from an integer codebook and everything compared between
ranks are exact. Decoded `.uvtg` floats agree with the JAX codec within
4 ulp of max|x| (XLA may contract the dequantize into an FMA; see
tests/test_torch_sequence.py) and exactly with the port's one-device
decode. The mean distortion, a float32 sum of 24,576 integer squares
taken in another order than XLA's, agrees within a relative 1e-5.

The reference's `build_palettes` takes its Pallas path only on a TPU; on
the CPU its XLA fallback runs bf16 k-means. As tests/test_torch_etc1s.py
does, the JAX builds here take the Pallas path in interpret mode, inside
the reference's `shard_map` for a mesh. At 2 ranks the port's build is
that build bit for bit; at 4 ranks the contract is quality parity with
one device (within 0.5 dB PSNR) and agreement between the ranks.
"""

import functools
import types
import warnings

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu_torch.parallel.ranks import run_ranks

SIZES = (2, 4)
PAL_FIELDS = ("color5", "inten", "selectors", "block_endpoint", "block_selector")


# ---- inputs (made once in the parent and sent to every rank) ----------------------

def _geometry(f: int, seed: int):
    """f frames of 257 vertices, ragged counts, with UVs and faces."""
    r = np.random.default_rng(seed)
    n = 257
    pos = r.normal(size=(f, n, 3)).astype(np.float32)
    uv = r.uniform(0, 1, (f, n, 2)).astype(np.float32)
    counts = np.array([n - (7 * i) % 11 for i in range(f)], np.int64)
    k = np.arange(40)
    faces = [np.stack([k, k + 1, k + 2], 1).astype(np.int32) % n] * f
    return pos, uv, counts, faces


def _ragged_frames(seed: int):
    r = np.random.default_rng(seed)
    counts = [100, 120, 2000, 110, 1900, 130, 2100, 105, 50, 75]
    pos = [r.normal(size=(c, 3)).astype(np.float32) for c in counts]
    uvs = [r.uniform(size=(c, 2)).astype(np.float32) for c in counts]
    faces = [np.stack([np.arange(c - 2), np.arange(1, c - 1), np.arange(2, c)], 1)
             .astype(np.int32) for c in counts]
    return pos, uvs, faces


def _etc1s_frames():
    """4 layers of 32^2 (256 blocks): gradients with noise."""
    r = np.random.default_rng(3)
    yy, xx = np.mgrid[0:32, 0:32]
    return np.stack([
        np.clip(np.stack([(xx * 6 + k) % 256, (yy * 6) % 256, (xx + yy + 4 * k) % 256], -1)
                + r.integers(-8, 9, (32, 32, 3)), 0, 255)
        for k in range(4)]).astype(np.uint8)


def _inputs() -> dict:
    r = np.random.default_rng(11)
    return {
        "geometry": {"even": _geometry(8, 5), "ragged": _geometry(6, 6)},
        "texture": {"even": r.integers(0, 256, (8, 32, 32, 3)).astype(np.uint8),
                    "ragged": r.integers(0, 256, (5, 32, 32, 3)).astype(np.uint8)},
        "bucketed": _ragged_frames(7),
        "etc1s": _etc1s_frames(),
        # 2,052 blocks: a palette of 2,049 endpoints, one past the kernels' window
        "etc1s_wide": r.integers(0, 256, (1, 108, 304, 3)).astype(np.uint8),
        "indivisible": r.integers(0, 256, (3, 12, 12, 3)).astype(np.uint8),  # 27 blocks
        "kmeans_blocks": r.integers(0, 256, (8, 64, 48)).astype(np.float32),
        "kmeans_codebook": r.integers(0, 256, (128, 48)).astype(np.float32),
    }


INPUTS = _inputs()


def _pal_dict(pal) -> dict:
    return {k: np.asarray(getattr(pal, k)) for k in PAL_FIELDS}


# ---- one rank ------------------------------------------------------------------------

def rank_job(inputs: dict, standins: dict) -> dict:
    """Everything the module checks, on this rank of a CPU group."""
    from uvol_tpu_torch.codecs.basis.etc1s_encode import build_palettes, encode_ktx2_etc1s
    from uvol_tpu_torch.containers.ktx2 import read_ktx2
    from uvol_tpu_torch.convert import from_jax_codec
    from uvol_tpu_torch.models.codebook import make_sharded_train_step
    from uvol_tpu_torch.models.sequence import (
        GeometryFrameSet,
        GeometrySequenceCodec,
        TextureSequenceCodec,
    )
    from uvol_tpu_torch.parallel.mesh import make_mesh, shard_frames

    mesh = make_mesh(device_type="cpu")
    out = {"geometry": {}, "texture": {}}
    geo = GeometrySequenceCodec(mesh=mesh)
    for case, (pos, uv, counts, faces) in inputs["geometry"].items():
        blobs = geo.encode(GeometryFrameSet(pos, uv, counts, faces))
        dec = geo.decode(blobs)
        dev = geo.decode(blobs, as_numpy=False)
        out["geometry"][case] = {"blobs": blobs, "positions": dec.positions, "uvs": dec.uvs,
                                 "resident": dev.positions.numpy()}
    for case, frames in inputs["texture"].items():
        tc = TextureSequenceCodec(sequence_size=len(frames), mesh=mesh)
        blob = tc.encode_segment(frames)
        out["texture"][case] = {"blob": blob, "decoded": tc.decode_segment(read_ktx2(blob))}
    out["bucketed"] = geo.encode_bucketed(*inputs["bucketed"])

    conv = {}
    for kind, (ok, bad) in standins.items():
        codec = from_jax_codec(ok, mesh=mesh)
        if kind == "geometry":
            pos, uv, counts, faces = inputs["geometry"]["ragged"]
            conv[kind] = codec.encode(GeometryFrameSet(pos, uv, counts, faces))
        else:
            conv[kind] = codec.encode_segment(inputs["texture"]["ragged"])
        errors = []
        for args in ((bad, mesh), (ok, None)):
            try:
                from_jax_codec(args[0], mesh=args[1])
                errors.append("no error")
            except ValueError as e:
                errors.append(str(e))
        conv[kind + "_errors"] = errors
    out["from_jax_codec"] = conv

    frames = inputs["etc1s"]
    out["etc1s"] = {rdo: _pal_dict(build_palettes(frames, 32, 32, 2, rdo=rdo, mesh=mesh))
                    for rdo in (False, True)}
    out["etc1s_rerun"] = _pal_dict(build_palettes(frames, 32, 32, 2, rdo=True, mesh=mesh))
    out["etc1s_segment"] = encode_ktx2_etc1s(frames, num_endpoints=32, num_selectors=32,
                                             kmeans_iters=2, mesh=mesh)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pal = build_palettes(inputs["indivisible"], 16, 16, 2, rdo=False, mesh=mesh)
    out["indivisible"] = {"palettes": _pal_dict(pal),
                          "warnings": [(w.category.__name__, str(w.message)) for w in caught]}
    if torch.distributed.get_world_size() == 2:
        out["etc1s_wide"] = _pal_dict(build_palettes(inputs["etc1s_wide"], 2049, 64, 2,
                                                     rdo=False, mesh=mesh))

    step = make_sharded_train_step(mesh)
    local = shard_frames(mesh, inputs["kmeans_blocks"])
    cb = torch.from_numpy(inputs["kmeans_codebook"])
    codebooks, distortions = [], []
    for _ in range(3):
        cb, dist_mean = step(local, cb)
        codebooks.append(cb.numpy())
        distortions.append(float(dist_mean))
    out["kmeans"] = {"codebooks": codebooks, "distortions": distortions}
    return out


@pytest.fixture(scope="module")
def jmesh():
    from uvol_tpu.parallel.mesh import make_mesh

    return {k: make_mesh(k) for k in SIZES}


@pytest.fixture(scope="module")
def jax_codecs(jmesh):
    from uvol_tpu.models import sequence as jseq

    return {
        "geometry": {k: jseq.GeometrySequenceCodec(use_pallas=False, mesh=jmesh.get(k))
                     for k in (None, *SIZES)},
        "texture": {(k, case): jseq.TextureSequenceCodec(
            sequence_size=len(INPUTS["texture"][case]), use_pallas=False, mesh=jmesh.get(k))
            for k in (None, *SIZES) for case in INPUTS["texture"]},
    }


@pytest.fixture(scope="module")
def ranks(jax_codecs):
    """{k: [rank 0's result, ...]} for the groups of 2 and 4 ranks."""
    out = {}
    for k in SIZES:
        standins = {}
        for kind, jc in (("geometry", jax_codecs["geometry"][k]),
                         ("texture", jax_codecs["texture"][(k, "ragged")])):
            cfg = {n: getattr(jc, n) for n in ("position_bits", "uv_bits", "sequence_size",
                                               "supercompression") if hasattr(jc, n)}
            ok = types.SimpleNamespace(**cfg, mesh=types.SimpleNamespace(shape=dict(jc.mesh.shape)))
            bad = types.SimpleNamespace(**cfg, mesh=types.SimpleNamespace(
                shape={"frames": k + 1}))
            standins[kind] = (ok, bad)
        out[k] = run_ranks(rank_job, k, INPUTS, standins, device_type="cpu", timeout=400)
    return out


@pytest.fixture(scope="module")
def jax_pallas_builds(jmesh):
    """The reference's builds on its Pallas path (interpret mode), inside
    its `shard_map` for a mesh: {(k, rdo): palettes} and the segment at 2."""
    import jax

    from uvol_tpu.codecs.basis import etc1s_encode as jenc

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(jenc, "_palette_core_fn",
                   functools.partial(jenc._palette_core_fn, pallas_interpret=True))
        mp.setattr(jenc, "_PALETTE_JIT_CACHE", {})
        frames = INPUTS["etc1s"]
        builds = {(k, rdo): _pal_dict(jenc.build_palettes(frames, 32, 32, kmeans_iters=2,
                                                          rdo=rdo, mesh=jmesh.get(k)))
                  for k in (None, 2) for rdo in (False, True)}
        segment = jenc.encode_ktx2_etc1s(frames, num_endpoints=32, num_selectors=32,
                                         kmeans_iters=2, mesh=jmesh[2])
    return builds, segment


def _palette_psnr(frames: np.ndarray, pal: dict) -> float:
    from uvol_tpu.codecs.basis.transcoder import INTEN_TABLES

    f, h, w, _ = frames.shape
    base = (pal["color5"].astype(np.int32) << 3) | (pal["color5"].astype(np.int32) >> 2)
    mods = np.asarray(INTEN_TABLES)
    blocks = (frames.reshape(f, h // 4, 4, w // 4, 4, 3).transpose(0, 1, 3, 2, 4, 5)
              .reshape(-1, 16, 3).astype(np.int32))
    e, s = pal["block_endpoint"].reshape(-1), pal["block_selector"].reshape(-1)
    m = mods[pal["inten"][e]][np.arange(len(e))[:, None], pal["selectors"][s]]
    recon = np.clip(base[e][:, None, :] + m[:, :, None], 0, 255)
    return float(10 * np.log10(255**2 / max(((recon - blocks) ** 2).mean(), 1e-9)))


def _atol(x: np.ndarray) -> float:
    return 4 * float(np.finfo(np.float32).eps) * float(np.abs(x).max())


# ---- the sequence codecs --------------------------------------------------------------

@pytest.mark.parametrize("case", ["even", "ragged"])
@pytest.mark.parametrize("k", SIZES)
def test_geometry_bytes_match_jax(ranks, jax_codecs, k, case):
    """Sharded `.uvtg` blobs = the JAX codec's on one device and on its
    k-device mesh (6 frames over 4 ranks: padded), on every rank."""
    from uvol_tpu.models.sequence import GeometryFrameSet as JFrames

    frames = JFrames(*INPUTS["geometry"][case])
    want = [bytes(b) for b in jax_codecs["geometry"][None].encode(frames)]
    assert [bytes(b) for b in jax_codecs["geometry"][k].encode(frames)] == want
    for res in ranks[k]:
        assert res["geometry"][case]["blobs"] == want


@pytest.mark.parametrize("case", ["even", "ragged"])
@pytest.mark.parametrize("k", SIZES)
def test_geometry_decode_matches(ranks, jax_codecs, k, case):
    from uvol_tpu_torch.models.sequence import GeometrySequenceCodec

    blobs = ranks[k][0]["geometry"][case]["blobs"]
    one = GeometrySequenceCodec(device="cpu").decode(blobs)
    jdec = jax_codecs["geometry"][k].decode(blobs)
    for res in ranks[k]:
        got = res["geometry"][case]
        np.testing.assert_array_equal(got["positions"], one.positions)
        np.testing.assert_array_equal(got["uvs"], one.uvs)
        np.testing.assert_array_equal(got["resident"].transpose(0, 2, 1), one.positions)
        np.testing.assert_allclose(got["positions"], np.asarray(jdec.positions), rtol=0,
                                   atol=_atol(np.asarray(jdec.positions)))
        np.testing.assert_allclose(got["uvs"], np.asarray(jdec.uvs), rtol=0,
                                   atol=_atol(np.asarray(jdec.uvs)))


@pytest.mark.parametrize("case", ["even", "ragged"])
@pytest.mark.parametrize("k", SIZES)
def test_texture_bytes_match_jax(ranks, jax_codecs, k, case):
    frames = INPUTS["texture"][case]
    want = jax_codecs["texture"][(None, case)].encode_segment(frames)
    assert jax_codecs["texture"][(k, case)].encode_segment(frames) == want
    for res in ranks[k]:
        assert res["texture"][case]["blob"] == want


@pytest.mark.parametrize("case", ["even", "ragged"])
@pytest.mark.parametrize("k", SIZES)
def test_texture_decode_matches_jax(ranks, jax_codecs, k, case):
    from uvol_tpu.containers.ktx2 import read_ktx2

    blob = ranks[k][0]["texture"][case]["blob"]
    want = np.asarray(jax_codecs["texture"][(k, case)].decode_segment(read_ktx2(blob)))
    for res in ranks[k]:
        np.testing.assert_array_equal(res["texture"][case]["decoded"], want)


@pytest.mark.parametrize("k", SIZES)
def test_encode_bucketed_with_mesh_matches_jax(ranks, jax_codecs, k):
    """Bucket lengths rounded to the mesh size, blobs in input order."""
    want = [bytes(b) for b in jax_codecs["geometry"][k].encode_bucketed(*INPUTS["bucketed"])]
    assert want == [bytes(b) for b in
                    jax_codecs["geometry"][None].encode_bucketed(*INPUTS["bucketed"])]
    for res in ranks[k]:
        assert res["bucketed"] == want


@pytest.mark.parametrize("kind", ["geometry", "texture"])
@pytest.mark.parametrize("k", SIZES)
def test_from_jax_codec_with_a_mesh(ranks, jax_codecs, k, kind):
    """A meshed JAX codec converts with the port's mesh of the same size
    and writes its bytes; a mesh of another size, or none, raises
    ValueError naming both sizes."""
    from uvol_tpu.models.sequence import GeometryFrameSet as JFrames

    if kind == "geometry":
        want = [bytes(b) for b in jax_codecs["geometry"][k].encode(
            JFrames(*INPUTS["geometry"]["ragged"]))]
    else:
        want = jax_codecs["texture"][(k, "ragged")].encode_segment(INPUTS["texture"]["ragged"])
    for res in ranks[k]:
        got = res["from_jax_codec"]
        assert got[kind] == want
        wrong, missing = got[kind + "_errors"]
        assert f"{k + 1} devices" in wrong and f"{k} ranks" in wrong
        assert f"{k} devices" in missing and "1 ranks" in missing


# ---- the ETC1S palette build and segment -------------------------------------------------

@pytest.mark.parametrize("field", PAL_FIELDS)
@pytest.mark.parametrize("rdo", [False, True])
def test_etc1s_two_ranks_bit_equal_to_reference_shard_map(ranks, jax_pallas_builds, rdo, field):
    builds, _ = jax_pallas_builds
    want = builds[(2, rdo)][field]
    for res in ranks[2]:
        np.testing.assert_array_equal(res["etc1s"][rdo][field], want)


def test_etc1s_segment_two_ranks_matches_reference(ranks, jax_pallas_builds):
    _, want = jax_pallas_builds
    for res in ranks[2]:
        assert res["etc1s_segment"] == want


@pytest.mark.parametrize("rdo", [False, True])
def test_etc1s_four_ranks_quality_parity(ranks, jax_pallas_builds, rdo):
    """Within 0.5 dB of the one-device build (the reference's contract for
    a sharded build), and the same palettes on every rank."""
    builds, _ = jax_pallas_builds
    frames = INPUTS["etc1s"]
    one = _palette_psnr(frames, builds[(None, rdo)])
    res0 = ranks[4][0]["etc1s"][rdo]
    assert abs(_palette_psnr(frames, res0) - one) < 0.5
    for res in ranks[4][1:]:
        for field in PAL_FIELDS:
            np.testing.assert_array_equal(res["etc1s"][rdo][field], res0[field])


def test_etc1s_two_ranks_past_one_window(ranks):
    """2,049 endpoints on 2 ranks: the kernels' windows of 2,048, each
    window's partials summed over the ranks. The palette is built (it was
    refused before the windows), the same on both ranks, and within 0.5 dB
    of the one-device build, the sharded build's contract."""
    from uvol_tpu_torch.codecs.basis.etc1s_encode import build_palettes

    frames = INPUTS["etc1s_wide"]
    one = _pal_dict(build_palettes(frames, 2049, 64, 2, rdo=False, device="cpu"))
    res0 = ranks[2][0]["etc1s_wide"]
    assert len(res0["color5"]) == len(one["color5"]) == 2049
    assert abs(_palette_psnr(frames, res0) - _palette_psnr(frames, one)) < 0.5
    for res in ranks[2][1:]:
        for field in PAL_FIELDS:
            np.testing.assert_array_equal(res["etc1s_wide"][field], res0[field])


@pytest.mark.parametrize("k", SIZES)
def test_etc1s_rerun_is_identical(ranks, k):
    for res in ranks[k]:
        for field in PAL_FIELDS:
            np.testing.assert_array_equal(res["etc1s_rerun"][field], res["etc1s"][True][field])
        assert res["etc1s_segment"] == ranks[k][0]["etc1s_segment"]


@pytest.mark.parametrize("k", SIZES)
def test_etc1s_indivisible_falls_back(ranks, k):
    """27 blocks over k ranks: a RuntimeWarning "not divisible", then the
    one-device build."""
    from uvol_tpu_torch.codecs.basis.etc1s_encode import build_palettes

    want = _pal_dict(build_palettes(INPUTS["indivisible"], 16, 16, 2, rdo=False, device="cpu"))
    for res in ranks[k]:
        got = res["indivisible"]
        assert any(c == "RuntimeWarning" and "not divisible" in m for c, m in got["warnings"])
        for field in PAL_FIELDS:
            np.testing.assert_array_equal(got["palettes"][field], want[field])


# ---- the codebook (U2) ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_kmeans_assign_matches_jax(seed):
    """Integer blocks and codewords in [0, 256) are exact in bf16 and their
    dots exact in float32: the assignments must be equal."""
    import jax.numpy as jnp

    from uvol_tpu.models.codebook import kmeans_assign as jassign
    from uvol_tpu_torch.models.codebook import kmeans_assign

    r = np.random.default_rng(seed)
    blocks = r.integers(0, 256, (500, 48)).astype(np.float32)
    cb = r.integers(0, 256, (64, 48)).astype(np.float32)
    cb[7] = cb[3]  # a tie: the first minimum wins
    want = np.asarray(jassign(jnp.asarray(blocks), jnp.asarray(cb)))
    got = kmeans_assign(torch.from_numpy(blocks), torch.from_numpy(cb))
    np.testing.assert_array_equal(got.numpy(), want)


def test_kmeans_assign_rounds_operands_to_bf16():
    """Values that bf16 rounds: the port rounds them as the reference does
    (257 -> 256, 0.3 -> 0.30078125) before the float32 product."""
    from uvol_tpu_torch.models.codebook import kmeans_assign

    blocks = torch.tensor([[257.0, 0.3]])
    cb = torch.tensor([[256.0, 0.30078125], [257.0, 0.3]])
    # in bf16 both codewords are [256, 0.30078125]: a tie, the first wins
    assert kmeans_assign(blocks, cb).tolist() == [0]


@pytest.mark.parametrize("k", SIZES)
def test_kmeans_update_matches_jax_shard_map(ranks, jmesh, k):
    """The first step from an integer codebook: sums and counts exact, so
    the codebook equals the reference's `psum` step bit for bit; the mean
    distortion within a relative 1e-5 (float32 sums in two orders)."""
    import jax.numpy as jnp

    from uvol_tpu.models.codebook import make_sharded_train_step as jstep
    from uvol_tpu.parallel.mesh import shard_frames

    cb, dist_mean = jstep(jmesh[k])(shard_frames(jmesh[k], jnp.asarray(INPUTS["kmeans_blocks"])),
                                    jnp.asarray(INPUTS["kmeans_codebook"]))
    for res in ranks[k]:
        np.testing.assert_array_equal(res["kmeans"]["codebooks"][0], np.asarray(cb))
        np.testing.assert_allclose(res["kmeans"]["distortions"][0], float(dist_mean), rtol=1e-5)


@pytest.mark.parametrize("k", SIZES)
def test_sharded_train_step_is_monotone(ranks, k):
    d = ranks[k][0]["kmeans"]["distortions"]
    assert d[1] <= d[0] + 1e-3 and d[2] <= d[1] + 1e-3
    for res in ranks[k][1:]:
        assert res["kmeans"]["distortions"] == d
        for a, b in zip(res["kmeans"]["codebooks"], ranks[k][0]["kmeans"]["codebooks"]):
            np.testing.assert_array_equal(a, b)


# ---- every rank holds the same results ------------------------------------------------------

@pytest.mark.parametrize("part", ["geometry", "texture", "bucketed", "from_jax_codec",
                                  "etc1s_segment"])
@pytest.mark.parametrize("k", SIZES)
def test_ranks_agree(ranks, k, part):
    def flat(x):
        if isinstance(x, dict):
            return {key: flat(v) for key, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [flat(v) for v in x]
        return x.tobytes() if isinstance(x, np.ndarray) else x

    first = flat(ranks[k][0][part])
    for res in ranks[k][1:]:
        assert flat(res[part]) == first


def test_dryrun_multichip_four_cpu_ranks():
    """The port's counterpart of `__graft_entry__.dryrun_multichip`."""
    from uvol_tpu_torch.entry import dryrun_multichip

    res = dryrun_multichip(4, device_type="cpu", timeout=300)
    assert res["distortion"][1] <= res["distortion"][0] + 1e-3
    assert res["streams_total"] >= 0
