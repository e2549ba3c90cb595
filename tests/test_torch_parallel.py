"""The port's parallel layer (`uvol_tpu_torch.parallel`) on the CPU.

`pad_frames_to_mesh` and `bucket_frames_by_count` are held against the
JAX package's (`uvol_tpu.parallel.mesh`, on its 8 virtual CPU devices).
The meshes and collectives run on one spawned group of 4 gloo ranks on
the CPU (`rank_job`, once per module): a 1-D `frames` mesh and a 2 x 2
`streams x frames` mesh, the rank-ordered gather (bits unchanged: -0.0,
NaN payloads, integers) and sum (from 0.0 in rank order: the same bits on
every rank, a sum of -0.0 is +0.0, NaN propagates), `shard_frames`,
`replicate_to_host`, and the transport chosen when the mesh was made.
Every comparison is exact.
"""

import time

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu_torch.parallel import mesh as pmesh
from uvol_tpu_torch.parallel.ranks import run_ranks

WORLD = 4
#: float32 bit patterns that a sum or a copy could change: -0.0, a quiet
#: NaN with a payload, a negative NaN, +-inf, the smallest subnormal, 1.0
SPECIAL_BITS = np.array([0x80000000, 0x7FC00123, 0xFFC00001, 0x7F800000, 0xFF800000,
                         0x00000001, 0x3F800000], np.uint32)


def _rank_values(rank: int) -> np.ndarray:
    """Rank r's float32 partials: random values, then the special bits."""
    r = np.random.default_rng(100 + rank)
    vals = r.normal(size=16).astype(np.float32) * np.float32(10.0 ** rank)
    return np.concatenate([vals, SPECIAL_BITS.view(np.float32)])


def rank_job() -> dict:
    """One rank of the module's group: meshes, collectives, shards."""
    import torch.distributed as dist

    mesh = pmesh.make_mesh(device_type="cpu")
    rank = dist.get_rank()
    mine = torch.from_numpy(_rank_values(rank))
    out = {
        "rank": rank,
        "mesh1": {"names": mesh.mesh_dim_names, "size": pmesh.axis_size(mesh),
                  "axis_rank": pmesh.axis_rank(mesh),
                  "multiprocess": pmesh.mesh_is_multiprocess(mesh),
                  "device": str(pmesh.mesh_device(mesh)),
                  "transport": dict(mesh._uvt_transport)},
        "gather_f32": pmesh.all_gather_in_rank_order(mesh, mine).numpy().view(np.uint32),
        "gather_i32": pmesh.all_gather_in_rank_order(
            mesh, torch.arange(3, dtype=torch.int32) + 10 * rank).numpy(),
        "gather_u8": pmesh.all_gather_in_rank_order(
            mesh, torch.full((2, 3), rank, dtype=torch.uint8)).numpy(),
        "sum_f32": pmesh.all_sum_in_rank_order(mesh, mine).numpy().view(np.uint32),
        "sum_neg_zero": pmesh.all_sum_in_rank_order(
            mesh, torch.full((3,), -0.0)).numpy().view(np.uint32),
        "sum_i64": pmesh.all_sum_in_rank_order(mesh, torch.tensor([rank, 1 << 40])).numpy(),
    }
    frames = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    local = pmesh.shard_frames(mesh, frames)
    out["shard"] = local.numpy()
    out["shard_dim1"] = pmesh.shard_frames(mesh, frames.T.copy(), frame_dim=1).numpy()
    tree = pmesh.replicate_to_host(mesh, {"a": local, "b": (local * 2, None)})
    out["replicated"] = {"a": tree["a"].numpy(), "b": tree["b"][0].numpy(),
                         "none_kept": tree["b"][1] is None}
    try:
        pmesh.shard_frames(mesh, frames[:7])
        out["ragged_shard"] = "no error"
    except ValueError as e:
        out["ragged_shard"] = str(e)
    out["pad1"] = {f: _pad_record(pmesh.pad_frames_to_mesh(np.ones((f, 2), np.int8), mesh))
                   for f in range(1, 10)}

    mesh2 = pmesh.make_mesh(axis_shapes=(2, 2), axis_names=("streams", "frames"),
                            device_type="cpu")
    out["mesh2"] = {"names": mesh2.mesh_dim_names,
                    "sizes": [pmesh.axis_size(mesh2, a) for a in ("streams", "frames")],
                    "ranks": [pmesh.axis_rank(mesh2, a) for a in ("streams", "frames")],
                    "frames_group": dist.get_process_group_ranks(mesh2.get_group("frames")),
                    "transport": dict(mesh2._uvt_transport)}
    part = pmesh.all_sum_in_rank_order(mesh2, mine, "frames")
    out["sum2_frames"] = part.numpy().view(np.uint32)
    out["sum2_nested"] = pmesh.all_sum_in_rank_order(mesh2, part, "streams").numpy().view(
        np.uint32)
    out["gather2_frames"] = pmesh.all_gather_in_rank_order(
        mesh2, torch.tensor([rank]), "frames").numpy()
    out["pad2"] = {f: _pad_record(pmesh.pad_frames_to_mesh(np.ones((f, 2), np.int8), mesh2))
                   for f in range(1, 10)}
    for bad in ({"n": 3}, {"axis_shapes": (3, 2), "axis_names": ("streams", "frames")}):
        try:
            pmesh.make_mesh(device_type="cpu", **bad)
            out.setdefault("bad_mesh", []).append("no error")
        except ValueError as e:
            out.setdefault("bad_mesh", []).append(str(e))
    return out


def _pad_record(padded):
    arr, n = padded
    return arr.shape, n, int(arr[n:].sum())


def failing_job():
    import torch.distributed as dist

    pmesh.make_mesh(device_type="cpu")
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    # rank 0 waits on a collective that rank 1 never joins
    pmesh.all_gather_in_rank_order(pmesh.make_mesh(device_type="cpu"), torch.zeros(1))


def hanging_job():
    time.sleep(3600)


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(rank_job, WORLD, device_type="cpu", timeout=240)


def _sum_in_order(parts):
    acc = np.float32(0.0)
    for p in parts:
        acc = np.float32(acc + p)
    return acc


# ---- pad_frames_to_mesh / bucket_frames_by_count against the JAX package --------

BUCKET_COUNTS = {
    "random": np.random.default_rng(9).integers(1, 5000, 40),
    "skewed": np.array([100, 120, 2000, 110, 1900, 130, 2100, 105, 50000, 7, 7, 7, 3000]),
    "equal": np.full(11, 640),
    "one": np.array([5]),
}


@pytest.mark.parametrize("max_waste", [0.0, 0.1, 0.25, 0.5])
@pytest.mark.parametrize("mesh_size", [1, 2, 4, 8])
@pytest.mark.parametrize("counts", list(BUCKET_COUNTS))
def test_bucket_frames_matches_jax(counts, mesh_size, max_waste):
    from uvol_tpu.parallel.mesh import bucket_frames_by_count as jbucket

    c = BUCKET_COUNTS[counts]
    want = jbucket(c, mesh_size, max_waste)
    got = pmesh.bucket_frames_by_count(c, mesh_size, max_waste)
    assert [list(b) for b in got] == [list(b) for b in want]
    assert sorted(np.concatenate(got).tolist()) == list(range(len(c)))


@pytest.mark.parametrize("which", ["pad1", "pad2"])
def test_pad_frames_matches_jax(ranks, which):
    from uvol_tpu.parallel.mesh import make_mesh as jmake_mesh
    from uvol_tpu.parallel.mesh import pad_frames_to_mesh as jpad

    jmesh = (jmake_mesh(4) if which == "pad1" else
             jmake_mesh(4, axis_shapes=(2, 2), axis_names=("streams", "frames")))
    for f in range(1, 10):
        want = _pad_record(jpad(np.ones((f, 2), np.int8), jmesh))
        for res in ranks:
            assert res[which][f] == want, (f, res["rank"])


# ---- meshes ----------------------------------------------------------------------

@pytest.mark.parametrize("rank", range(WORLD))
def test_mesh_1d(ranks, rank):
    m = ranks[rank]["mesh1"]
    assert ranks[rank]["rank"] == rank
    assert m == {"names": ("frames",), "size": WORLD, "axis_rank": rank, "multiprocess": True,
                 "device": "cpu", "transport": {"frames": "device"}}


@pytest.mark.parametrize("rank", range(WORLD))
def test_mesh_2d(ranks, rank):
    m = ranks[rank]["mesh2"]
    assert m["names"] == ("streams", "frames") and m["sizes"] == [2, 2]
    assert m["ranks"] == [rank // 2, rank % 2]  # row-major: streams outer
    assert m["frames_group"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
    assert m["transport"] == {"streams": "device", "frames": "device"}
    np.testing.assert_array_equal(ranks[rank]["gather2_frames"], m["frames_group"])


def test_bad_mesh_shapes_raise(ranks):
    msgs = ranks[0]["bad_mesh"]
    assert "spans every rank (4), not 3" in msgs[0]
    assert "do not lay out 4 ranks" in msgs[1]


def test_make_mesh_on_the_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CPU-only refusal cannot show")
    with pytest.raises(RuntimeError, match="cuda"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        pmesh.rank_device("cuda")
    assert pmesh.rank_device("cpu") == torch.device("cpu")


def test_initialize_distributed_single_process(monkeypatch):
    """One process is no distributed run: False, and no group is made."""
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pmesh.initialize_distributed(device_type="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert pmesh.initialize_distributed(device_type="cpu") is False
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="RANK"):
        pmesh.initialize_distributed(device_type="cpu")


# ---- the rank-ordered gather and sum -----------------------------------------------

@pytest.mark.parametrize("rank", range(WORLD))
def test_gather_keeps_bits_in_rank_order(ranks, rank):
    res = ranks[rank]
    want = np.concatenate([_rank_values(r) for r in range(WORLD)]).view(np.uint32)
    np.testing.assert_array_equal(res["gather_f32"], want)
    np.testing.assert_array_equal(res["gather_i32"],
                                  np.concatenate([np.arange(3) + 10 * r for r in range(WORLD)]))
    np.testing.assert_array_equal(res["gather_u8"],
                                  np.repeat(np.arange(WORLD, dtype=np.uint8), 2)[:, None]
                                  .repeat(3, 1))


@pytest.mark.parametrize("rank", range(WORLD))
def test_sum_in_rank_order(ranks, rank):
    res = ranks[rank]
    parts = np.stack([_rank_values(r) for r in range(WORLD)])
    want = np.array([_sum_in_order(parts[:, i]) for i in range(parts.shape[1])], np.float32)
    np.testing.assert_array_equal(res["sum_f32"], want.view(np.uint32))
    # the same bits on every rank
    np.testing.assert_array_equal(res["sum_f32"], ranks[0]["sum_f32"])
    # summed from 0.0: -0.0 on every rank adds up to +0.0; NaN stays NaN; inf + -inf is NaN
    np.testing.assert_array_equal(res["sum_neg_zero"], np.zeros(3, np.uint32))
    tail = res["sum_f32"][16:].view(np.float32)
    assert tail[0] == 0.0 and not np.signbit(tail[0])
    assert np.isnan(tail[1]) and np.isnan(tail[2])
    assert tail[3] == np.inf and tail[4] == -np.inf
    assert tail[5:6].view(np.uint32)[0] == 4  # four smallest subnormals, not flushed
    np.testing.assert_array_equal(res["sum_i64"], [0 + 1 + 2 + 3, 4 << 40])


@pytest.mark.parametrize("rank", range(WORLD))
def test_nested_sums_on_the_2d_mesh(ranks, rank):
    res = ranks[rank]
    parts = np.stack([_rank_values(r) for r in range(WORLD)])
    row = rank // 2
    frames_sum = np.array([_sum_in_order(parts[2 * row:2 * row + 2, i])
                           for i in range(parts.shape[1])], np.float32)
    np.testing.assert_array_equal(res["sum2_frames"], frames_sum.view(np.uint32))
    rows = [np.array([_sum_in_order(parts[2 * s:2 * s + 2, i]) for i in range(parts.shape[1])],
                     np.float32) for s in range(2)]
    nested = np.array([_sum_in_order([rows[0][i], rows[1][i]]) for i in range(parts.shape[1])],
                      np.float32)
    np.testing.assert_array_equal(res["sum2_nested"], nested.view(np.uint32))


# ---- shards ------------------------------------------------------------------------

@pytest.mark.parametrize("rank", range(WORLD))
def test_shard_and_replicate(ranks, rank):
    res = ranks[rank]
    frames = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    np.testing.assert_array_equal(res["shard"], frames[2 * rank:2 * rank + 2])
    np.testing.assert_array_equal(res["shard_dim1"], frames.T[:, 2 * rank:2 * rank + 2])
    np.testing.assert_array_equal(res["replicated"]["a"], frames)
    np.testing.assert_array_equal(res["replicated"]["b"], frames * 2)
    assert res["replicated"]["none_kept"]
    assert "do not divide over 4 ranks" in res["ragged_shard"]


# ---- the backend and transport rules -----------------------------------------------

@pytest.mark.parametrize("device_type,local_world,count,want", [
    ("cuda", 1, 1, "nccl"),   # one rank on one card
    ("cuda", 4, 4, "nccl"),   # a card each
    ("cuda", 2, 8, "nccl"),
    ("cuda", 4, 1, "gloo"),   # four ranks share cuda:0: NCCL refuses two ranks on one GPU
    ("cuda", 3, 2, "gloo"),
    ("cpu", 1, 0, "gloo"),
    ("cpu", 4, 8, "gloo"),
])
def test_choose_backend(device_type, local_world, count, want):
    assert pmesh.choose_backend(device_type, local_world, count) == want


@pytest.mark.parametrize("backend,device_type,want", [
    ("nccl", "cuda", "device"),
    ("gloo", "cuda", "host"),   # gloo's CUDA support is broadcast and all_reduce only
    ("gloo", "cpu", "device"),
    ("nccl", "cpu", ValueError),
    ("mpi", "cpu", ValueError),
])
def test_choose_transport(backend, device_type, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            pmesh.choose_transport(backend, device_type)
    else:
        assert pmesh.choose_transport(backend, device_type) == want


# ---- the launcher: a failing or hung rank ends the run ------------------------------

def test_failing_rank_raises_and_the_rest_are_killed():
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(failing_job, 2, device_type="cpu", timeout=120)
    assert time.monotonic() - t < 60  # rank 0 did not wait out its collective


def test_hung_rank_times_out_and_is_killed():
    t = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after 6"):
        run_ranks(hanging_job, 2, device_type="cpu", timeout=6)
    assert time.monotonic() - t < 30
