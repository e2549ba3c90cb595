"""A multi-process run through the torchrun environment contract, with
a byte-parity check — counterpart of `uvol_tpu/parallel/multihost.py`.

`run_multiprocess_check(nodes, local_ranks)` launches nodes x
local_ranks processes of

    python -m uvol_tpu_torch.parallel.multihost --worker OUT.json [--device-type cpu]

each with MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK and
LOCAL_WORLD_SIZE set as torchrun sets them (one host standing in for
the nodes). Every worker joins the group through
`initialize_distributed`, runs the mesh-sharded production codecs
(`run_codecs`) over a mesh of every rank and writes their artifacts'
hashes; every process must write the same hashes, which must equal the
single-process codecs' (`run_codecs(None, ...)`).
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

_HASH_KEYS = ("geo_blobs", "geo_decoded", "tex_blob", "tex_decoded")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_check_inputs(n_frames: int, n_verts: int = 96, hw: int = 16):
    """Deterministic inputs shared by workers and the single-process
    check (the reference's, in the same rng stream order)."""
    import numpy as np

    r = np.random.default_rng(0)
    positions = r.normal(size=(n_frames, n_verts, 3)).astype(np.float32)
    uvs = r.uniform(0, 1, (n_frames, n_verts, 2)).astype(np.float32)
    counts = np.full(n_frames, n_verts, np.int64)
    k = np.arange(32)
    faces = [(np.stack([k, k + 1, k + 2], 1).astype(np.int32) % n_verts)] * n_frames
    textures = r.integers(0, 256, (n_frames, hw, hw, 3)).astype(np.uint8)
    return positions, uvs, counts, faces, textures


def run_codecs(mesh, n_frames: int, *, device=None) -> dict:
    """Encode and decode with the production codecs (mesh-sharded when
    `mesh` is given, else on `device`); the SHA-256 of each artifact."""
    import numpy as np

    from uvol_tpu_torch.containers.ktx2 import read_ktx2
    from uvol_tpu_torch.models.sequence import (
        GeometryFrameSet,
        GeometrySequenceCodec,
        TextureSequenceCodec,
    )

    positions, uvs, counts, faces, textures = make_check_inputs(n_frames)
    geo = GeometrySequenceCodec(device=device, mesh=mesh)
    blobs = geo.encode(GeometryFrameSet(positions, uvs, counts, faces))
    dec = geo.decode(blobs)
    # the device-resident output holds every frame on every rank too
    dev = geo.decode(blobs, as_numpy=False)
    if not np.array_equal(dev.positions.cpu().numpy().transpose(0, 2, 1), dec.positions):
        raise AssertionError("device-resident decode diverged")
    texc = TextureSequenceCodec(sequence_size=n_frames, device=device, mesh=mesh)
    tex_blob = texc.encode_segment(textures)
    tdec = texc.decode_segment(read_ktx2(tex_blob))
    return {
        "geo_blobs": hashlib.sha256(b"".join(blobs)).hexdigest(),
        "geo_decoded": hashlib.sha256(np.ascontiguousarray(dec.positions).tobytes()).hexdigest(),
        "tex_blob": hashlib.sha256(tex_blob).hexdigest(),
        "tex_decoded": hashlib.sha256(np.ascontiguousarray(tdec).tobytes()).hexdigest(),
    }


def worker_main(out_path: str, device_type: str = "cuda") -> None:
    """One process of the run: join the group from the environment, run
    the codecs over a mesh of every rank (2 frames a rank), write the
    hashes and this process's place in the group to `out_path`."""
    import torch.distributed as dist

    from uvol_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    if not initialize_distributed(device_type=device_type):
        raise RuntimeError("multi-process environment (WORLD_SIZE > 1, RANK, ...) missing")
    try:
        world = dist.get_world_size()
        hashes = run_codecs(make_mesh(device_type=device_type), n_frames=world * 2)
        hashes.update(rank=dist.get_rank(), world_size=world,
                      local_rank=int(os.environ["LOCAL_RANK"]),
                      backend=dist.get_backend())
        with open(out_path, "w") as fh:
            json.dump(hashes, fh)
    finally:
        dist.destroy_process_group()


def run_multiprocess_check(nodes: int = 2, local_ranks: int = 2, *,
                           device_type: str = "cuda", timeout: float = 420.0) -> dict:
    """Launch nodes x local_ranks workers through the env contract, check
    that every process wrote the same hashes and claimed a distinct rank,
    and return rank 0's record. A worker that fails raises here; after
    `timeout` seconds every worker still running is killed and this
    raises TimeoutError."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    world = nodes * local_ranks
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="uvt_multihost_") as tmp:
        procs, outs, logs = [], [], []
        try:
            for rank in range(world):
                out = os.path.join(tmp, f"rank{rank}.json")
                log = open(os.path.join(tmp, f"rank{rank}.log"), "w+b")
                outs.append(out)
                logs.append(log)
                env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           WORLD_SIZE=str(world), RANK=str(rank),
                           LOCAL_RANK=str(rank % local_ranks),
                           LOCAL_WORLD_SIZE=str(local_ranks),
                           GROUP_RANK=str(rank // local_ranks))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "uvol_tpu_torch.parallel.multihost",
                     "--worker", out, "--device-type", device_type],
                    env=env, cwd=repo_root, stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            for p in procs:
                try:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise TimeoutError(f"multihost workers still running after {timeout} s: "
                                       "killed") from None
                if p.returncode != 0:
                    break  # the others may wait on it forever
            failed = []
            for rank, (p, log) in enumerate(zip(procs, logs)):
                if p.returncode is not None and p.returncode != 0:
                    log.seek(0)
                    failed.append(f"worker {rank} (rc={p.returncode}):\n"
                                  + log.read().decode(errors="replace")[-4000:])
            if failed:
                raise RuntimeError("multihost workers failed:\n" + "\n".join(failed))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()
        results = []
        for out in outs:
            with open(out) as fh:
                results.append(json.load(fh))
    r0 = results[0]
    for r in results[1:]:
        for key in _HASH_KEYS:
            if r[key] != r0[key]:
                raise AssertionError(f"process parity violated for {key}: "
                                     f"rank {r['rank']} {r[key]} != rank 0 {r0[key]}")
    if sorted(r["rank"] for r in results) != list(range(world)):
        raise AssertionError("workers did not claim distinct ranks")
    return r0


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        device_type = sys.argv[4] if sys.argv[3:4] == ["--device-type"] else "cuda"
        worker_main(sys.argv[2], device_type)
    else:
        print(json.dumps(run_multiprocess_check(), indent=2))
