"""Each cell end to end on the CPU at a tiny size: the run comes out correct;
the control, and the program broken underneath in each way the cell can
fail, come out not correct. And the plain reference against the port."""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from uvbench import faults, harness, inputs
from uvbench.faults import FAULTS
from uvbench.ref import etc1 as ref

CELLS = ["v2-etc1s-1k.encode"]
SEED = 2**31 + 977


def _run(cell, control=False, seconds=1.0):
    return harness.run_cell(cell, SEED, seconds, False, "cpu", time.perf_counter(),
                            control=control)["result"]


@pytest.fixture(autouse=True)
def _threads_for_the_draco_pool(monkeypatch):
    """The Draco pool as threads in this process, so the faults below reach it
    (the traffic module binds the executor's name when a cell is loaded)."""
    import concurrent.futures

    monkeypatch.setattr(concurrent.futures, "ProcessPoolExecutor",
                        lambda n, mp_context=None: ThreadPoolExecutor(n))


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_cpu(tiny_cell, name):
    res = _run(tiny_cell(name))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"} and len(res["metrics"]) == 2
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_cell, name):
    res = _run(tiny_cell(name), control=True)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name,fault", sorted(FAULTS))
def test_broken_program_is_not_correct(tiny_cell, monkeypatch, name, fault):
    with faults.planted(name, fault, monkeypatch.setattr):
        res = _run(tiny_cell(name))
    assert not res["correct"], res["checks"]


def test_reference_etc1_equals_the_port():
    from uvol_tpu_torch.containers.ktx2 import read_ktx2
    from uvol_tpu_torch.models.sequence import TextureSequenceCodec

    tex = inputs.textures(SEED, 5, 32, 64, "cpu")
    codec = TextureSequenceCodec(5, device="cpu")
    seg = codec.encode_segment(tex)
    assert seg == ref.etc1_segment(tex)
    assert np.array_equal(codec.decode_segment(read_ktx2(seg)), ref.etc1_decode_segment(seg))


def test_reference_draco_equals_the_port():
    from uvol_tpu_torch.codecs.draco import constants as K
    from uvol_tpu_torch.codecs.draco.encoder import AttributeToEncode, encode_drc
    from uvbench.ref.codecs.draco.encoder import AttributeToEncode as RefAtt
    from uvbench.ref.codecs.draco.encoder import encode_drc as ref_encode_drc

    pos, uvs, nrm, faces = inputs.grid_frames(SEED, 2, 9, 13)
    c2v = faces.reshape(-1)
    for f in range(2):
        atts = [(K.ATT_POSITION, pos[f], 11), (K.ATT_TEX_COORD, uvs[f], 10),
                (K.ATT_NORMAL, nrm[f], 8)]
        prog = encode_drc(faces, [AttributeToEncode(t, v, c2v, b) for t, v, b in atts])
        assert prog == ref_encode_drc(faces, [RefAtt(t, v, c2v, b) for t, v, b in atts])


def test_inputs_follow_the_seed():
    a = inputs.textures(SEED, 3, 16, 32, "cpu")
    assert np.array_equal(a, inputs.textures(SEED, 3, 16, 32, "cpu"))
    assert not np.array_equal(a, inputs.textures(SEED + 1, 3, 16, 32, "cpu"))
    g = inputs.grid_frames(SEED, 3, 6, 11)
    assert all(np.array_equal(x, y) for x, y in zip(g, inputs.grid_frames(SEED, 3, 6, 11)))
    assert not np.array_equal(g[0][1], g[0][0])  # the grid moves from frame to frame
