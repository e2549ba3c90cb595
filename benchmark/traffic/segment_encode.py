"""Closed loop of V2 segment encodes as the port's CLI runs the upstream
default: Draco frames on a spawned process pool, then one ETC1S segment.

A request is one segment: its `KTX2_BATCH_SIZE` frames go through
`codecs.draco.encoder.encode_drc` on a pool of the CLI's kind (spawned,
`ENCODE_WORKERS` workers, 0 = one a core; the OBJ parse left out: the
workers get the frame's arrays), then its layers through
`codecs.basis.etc1s_encode.encode_ktx2_etc1s` at the configuration's
palettes. Requests walk the clip's segments in turn; the clip is made from
the seed in set-up.

Parameters: `frames` (the clip), `sample_drc_frames` and
`sample_segments`: how many of the window's `.drc` frames and segments
are compared, drawn from the seed after the window.

Correct:
  - each sampled `.drc` frame equals, byte for byte, the plain
    reference's: the frozen copy of the staged Python Draco encoder
    (`uvbench.ref.codecs.draco.encoder`, no native code) on the same arrays;
  - each sampled `.drc` frame decodes, by the frozen copy of the Python
    Draco decoder, to positions and UVs within half a step of its inputs
    and the input's faces (`uvbench.witness`);
  - each sampled `.ktx2` segment decodes, by the frozen copy of the
    BasisLZ transcoder (Python paths), to `KTX2_BATCH_SIZE` layers of the
    texture size; its palettes are the configuration's (the entries its
    endpoint and selector palettes lack, `etc1s_palette_short`); and the
    error it adds to the plain ETC1 reference's stays under the limits:
    its mean on smooth blocks (`etc1s_easy_excess_mse`) and its 90th
    percentile over all blocks (`etc1s_p90_excess_mse`; `block_excess`).
    A segment that does not decode reads infinite in each.
The control puts the reference encoder in the program's place at one
position bit fewer, and the program's ETC1S path at the palettes that
`control_palettes` gives.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from uvbench import drc_worker, inputs, witness
from uvbench.harness import Check
from uvbench.loops import closed_loop, rate
from uvbench.ref import etc1 as etc_ref
from uvbench.ref.codecs.basis.transcoder import transcode_ktx2_etc1s
from uvbench.ref.codecs.draco import constants as K
from uvbench.ref.codecs.draco.decoder import decode_drc
from uvbench.ref.codecs.draco.encoder import AttributeToEncode, encode_drc
from uvbench.ref.containers.ktx2 import read_ktx2


def _sizes(run):
    cfg = run.cfg
    h, w = cfg["TEXTURE_RESOLUTION"]
    return int(run.params["frames"]), int(cfg["KTX2_BATCH_SIZE"]), int(h), int(w)


def setup(run) -> None:
    from uvol_tpu_torch import native
    from uvol_tpu_torch.codecs.basis.etc1s_encode import encode_ktx2_etc1s

    cfg, st = run.cfg, run.state
    f, batch, h, w = _sizes(run)
    ny, nx = cfg["grid"]
    st["pos"], st["uvs"], st["nrm"], st["faces"] = inputs.grid_frames(run.seed, f, ny, nx)
    st["tex"] = inputs.textures(run.seed, f, h, w, run.device)
    run.log("inputs")
    st["encode"] = encode_ktx2_etc1s
    native.get_draco_lib()  # built before the pool, as the CLI does
    workers = int(cfg["ENCODE_WORKERS"]) or os.cpu_count() or 1
    st["pool"] = ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"))
    list(st["pool"].map(drc_worker.warm, range(workers)))
    run.log(f"draco pool of {workers}")
    _request(run, -1)  # warm-up: every kernel built and every shape seen once
    run.log("warm-up")


def _segment(run, i: int) -> int:
    f, batch, _h, _w = _sizes(run)
    return max(i, 0) % (f // batch)


def _request(run, i: int) -> dict:
    st, cfg, sp = run.state, run.cfg, run.spans
    f, batch, _h, _w = _sizes(run)
    s = _segment(run, i)
    frames = range(s * batch, (s + 1) * batch)
    qp, qt, qn = cfg["Q_POSITION_ATTR"], cfg["Q_TEXTURE_ATTR"], cfg["Q_NORMAL_ATTR"]
    if run.control:
        qp = qp - 1
    jobs = [(st["pos"][j], st["uvs"][j], st["nrm"][j], st["faces"], qp, qt, qn) for j in frames]
    with sp.span("drc_frames", i):
        if run.control:  # the reference in the program's place, at lower precision
            drc = [_reference_drc(*job) for job in jobs]
        else:
            out = list(st["pool"].map(drc_worker.encode_frame, jobs))
            drc = [b for b, _t0, _t1 in out]
            for _b, t0, t1 in out:
                sp.add("drc_encode", t0, t1, i)
    ne, ns = cfg["ETC1S_ENDPOINTS"], cfg["ETC1S_SELECTORS"]
    if run.control:
        ne, ns = run.params["control_palettes"]
    with sp.span("etc1s_segment", i):
        seg = st["encode"](st["tex"][s * batch:(s + 1) * batch], num_endpoints=ne,
                           num_selectors=ns, device=run.device)
    return {"frames": batch, "segment": s, "drc": drc, "ktx2": seg}


def _reference_drc(pos, uv, nrm, faces, qp, qt, qn) -> bytes:
    c2v = faces.reshape(-1)
    return encode_drc(faces, [AttributeToEncode(K.ATT_POSITION, pos, c2v, qp),
                              AttributeToEncode(K.ATT_TEX_COORD, uv, c2v, qt),
                              AttributeToEncode(K.ATT_NORMAL, nrm, c2v, qn)])


def window(run) -> None:
    run.records = closed_loop(lambda i: _request(run, i), run.start, run.deadline,
                              lambda i, now: run.tick(now))
    run.attempted = len(run.records)


def end_to_end(run) -> dict:
    return {"encode_fps": rate(sum(r["frames"] for r in run.records), run.start, run.records)}


def release(run) -> None:
    pool = run.state.pop("pool", None)
    if pool is not None:
        pool.shutdown(wait=True)
    run.state.pop("encode", None)


def _block_mse(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per 4x4 block mean squared error of [L, H, W, >=3] against [L, H, W, 3]."""
    d = (a[..., :3].astype(np.float64) - b.astype(np.float64)) ** 2
    l, h, w, _ = d.shape
    return d.reshape(l, h // 4, 4, w // 4, 4, 3).mean(axis=(2, 4, 5)).reshape(-1)


def block_excess(decoded: np.ndarray, src: np.ndarray, device):
    """The ETC1S error past the plain ETC1 reference's, per block the mean
    squared error of the one less the other's: (its mean over the blocks
    ETC1 encodes no worse than its median block, smooth ones where no
    two-colour limit dominates and the palettes' share shows; its 90th
    percentile over all blocks, which wrong selectors or endpoints on a
    tenth of the blocks or more raise, where the few edge blocks that no
    palette fixes do not)."""
    etc1 = _block_mse(etc_ref.etc1_decode_segment(etc_ref.etc1_segment(src, device), device), src)
    easy = etc1 <= np.median(etc1)
    excess = _block_mse(decoded, src) - etc1
    return float(excess[easy].mean()), float(np.percentile(excess, 90))


def check(run):
    st, cfg, p = run.state, run.cfg, run.params
    f, batch, h, w = _sizes(run)
    r = run.rng(17)
    pairs = [(ri, k) for ri in range(len(run.records)) for k in range(batch)]
    picks = r.choice(len(pairs), min(int(p["sample_drc_frames"]), len(pairs)), replace=False)
    drc_off, steps, faces_off = 0, 0.0, 0
    for pi in picks:
        ri, k = pairs[pi]
        rec = run.records[ri]
        j = rec["segment"] * batch + k
        want = _reference_drc(st["pos"][j], st["uvs"][j], st["nrm"][j], st["faces"],
                              cfg["Q_POSITION_ATTR"], cfg["Q_TEXTURE_ATTR"], cfg["Q_NORMAL_ATTR"])
        drc_off += rec["drc"][k] != want
        try:
            m = decode_drc(rec["drc"][k])
            err, same = witness.drc_frame(m.point_attribute(K.ATT_POSITION),
                                          m.point_attribute(K.ATT_TEX_COORD), m.faces,
                                          st["pos"][j], st["uvs"][j], st["faces"],
                                          cfg["Q_POSITION_ATTR"], cfg["Q_TEXTURE_ATTR"])
        except Exception as e:  # a frame the reference cannot decode fails the run
            print(f"frame {j} of request {ri} undecodable: {e!r}", file=sys.stderr)
            err, same = float("inf"), False
        steps, faces_off = max(steps, err), faces_off + (not same)
    segs = r.choice(len(run.records), min(int(p["sample_segments"]), len(run.records)),
                    replace=False)
    short, easy, excess = 0.0, 0.0, 0.0
    for ri in segs:
        rec = run.records[ri]
        src = st["tex"][rec["segment"] * batch:(rec["segment"] + 1) * batch]
        try:
            kf = read_ktx2(rec["ktx2"])
            got = transcode_ktx2_etc1s(kf, target="rgba")
            if got.shape[:3] != (batch, h, w):
                raise ValueError(f"decoded {got.shape}, expected {(batch, h, w)}")
        except Exception as e:  # a segment the transcoder cannot read fails the run
            print(f"segment {rec['segment']} of request {ri} unreadable: {e!r}", file=sys.stderr)
            short = easy = excess = float("inf")
            continue
        short += (cfg["ETC1S_ENDPOINTS"] - kf.basis_lz.endpoint_count
                  + cfg["ETC1S_SELECTORS"] - kf.basis_lz.selector_count)
        e_easy, e_p90 = block_excess(got, src, run.device)
        easy, excess = max(easy, e_easy), max(excess, e_p90)
    lim = p["limits"]
    return [Check("drc_frames_differing", drc_off, 0),
            Check("drc_dequant_steps", steps, float(lim["dequant_steps"])),
            Check("drc_faces_differing", faces_off, 0),
            Check("etc1s_palette_short", short, 0),
            Check("etc1s_easy_excess_mse", easy, float(lim["easy_excess_mse"])),
            Check("etc1s_p90_excess_mse", excess, float(lim["p90_excess_mse"]))]
