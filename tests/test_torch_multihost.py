"""The torchrun environment contract: 2 "nodes" x 2 local ranks, byte parity.

`run_multiprocess_check` launches 4 worker processes of
`python -m uvol_tpu_torch.parallel.multihost --worker` with MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK and LOCAL_WORLD_SIZE set (on
the CPU, gloo); each runs the mesh-sharded production codecs over a mesh
of the 4 ranks and writes its artifacts' hashes. Every process must
write the same hashes, and they must equal the port's single-process
codecs' and the JAX package's `run_codecs(mesh=None)` (exact: SHA-256 of
the bytes), but for the decoded positions, which agree with the JAX
codec's within 4 ulp of max|x| (XLA may contract its dequantize into an
FMA; tests/test_torch_sequence.py).
"""

import pytest

from uvol_tpu_torch.parallel.multihost import make_check_inputs, run_codecs, run_multiprocess_check

KEYS = ("geo_blobs", "geo_decoded", "tex_blob", "tex_decoded")


@pytest.fixture(scope="module")
def multihost_result():
    return run_multiprocess_check(2, 2, device_type="cpu", timeout=300)


@pytest.fixture(scope="module")
def single_process():
    return run_codecs(None, 8, device="cpu")


def test_env_contract_bringup(multihost_result):
    assert multihost_result["world_size"] == 4
    assert multihost_result["rank"] == 0 and multihost_result["local_rank"] == 0
    assert multihost_result["backend"] == "gloo"  # ranks on the CPU


@pytest.mark.parametrize("key", KEYS)
def test_multiprocess_matches_single_process(multihost_result, single_process, key):
    assert multihost_result[key] == single_process[key]


@pytest.fixture(scope="module")
def jax_single_process():
    from uvol_tpu.parallel.multihost import run_codecs as jax_run_codecs

    return jax_run_codecs(mesh=None, n_frames=8)


@pytest.mark.parametrize("key", KEYS)
def test_multiprocess_matches_jax_single_process(multihost_result, jax_single_process, key):
    if key != "geo_decoded":
        assert multihost_result[key] == jax_single_process[key]
        return
    # decoded floats: XLA may contract the JAX codec's dequantize into an
    # FMA (tests/test_torch_sequence.py), so they agree within 4 ulp of
    # max|x|; the port's own decode is the one the processes hashed
    import hashlib

    import numpy as np

    from uvol_tpu.models import sequence as jseq
    from uvol_tpu_torch.models import sequence as tseq

    pos, uv, counts, faces, _ = make_check_inputs(8)
    codec = tseq.GeometrySequenceCodec(device="cpu")
    blobs = codec.encode(tseq.GeometryFrameSet(pos, uv, counts, faces))
    got = codec.decode(blobs).positions
    assert hashlib.sha256(got.tobytes()).hexdigest() == multihost_result[key]
    want = np.asarray(jseq.GeometrySequenceCodec(use_pallas=False).decode(blobs).positions)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * float(np.finfo(np.float32).eps) * float(np.abs(want).max()))


def test_check_inputs_are_the_references():
    """The same rng stream order as the JAX package's `make_check_inputs`."""
    import numpy as np

    from uvol_tpu.parallel.multihost import make_check_inputs as jax_inputs

    for got, want in zip(make_check_inputs(8), jax_inputs(8)):
        if isinstance(want, list):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(got, want)


def test_a_failing_worker_raises():
    """A world of one process is no multi-process run: the worker exits
    non-zero, and the check raises with its log."""
    with pytest.raises(RuntimeError, match="multi-process environment"):
        run_multiprocess_check(1, 1, device_type="cpu", timeout=120)
