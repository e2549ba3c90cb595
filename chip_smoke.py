#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`uvol_tpu_torch`) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from `uvol_tpu_torch/csrc/` (nvcc, sm_90a,
one process per source), holds each kernel (K1-K8, U1, U3-U5, the fixed-order
segment sum and the geometry stage's minimum/maximum) bit-for-bit against
its plain PyTorch twin (the geometry stage on ragged masks, a frame of one
vertex, of equal values, without a valid vertex, rows whose minimum is both
zeros, vertex counts on and off the 16-byte grid and a batch 4 bytes off
it; the segment sum and K6 also above the 2^24 rows of one launch; K2 also on
random words at widths off its 16-byte store path and from words that are
only 8-byte aligned, K5 also off its CTA grid with every base at 0 and at
255), drives the
flagship codec chain at full width (32 frames x 26,145 vertices, 32
layers of 1024x1024; the geometry encode's device stage is 4 kernels: the
minimum/maximum and K3, for the positions and for the UVs) and the
ETC1S/BasisLZ segment encoder at the encoder CLI's segment (5 layers of
1024x1024) at 256/256 palettes and at the CLI's default 1024/1024, whose
delta-aware stage runs K7 (a whole frame of the rate sweep: error product,
column scan and CR snap) once per frame of each sweep, through the
codecs' public entry points, holds every K4-K7 and segment-sum call that
a segment encode makes against the plain twin on the same inputs, shows
one sweep frame to be one device kernel and a sweep to allocate no
[blocks, entries] error tile, checks the bytes against the
CPU codecs, counts the kernels one K6 or segment-sum call launches
(fixed, whatever N), times kernels and chains with CUDA events and the
kernels alone with the profiler, replays and times every segment-sum and
K6 call of a 256/256 and a 1,024/1,024 palette build
(`segment_sum_builds`), and traces one pass of each codec
stage with `torch.profiler` to split its time between host and device.

Its phase `drc_device_path` drives the real-`.drc` device decode
(`models/drc_device.py`, `runtime/device_stream.py`) at liam scale. It
makes 128 frames (32 distinct) with the port's own native Draco encoder:
83 x 315 grids (26,145 vertices, 51,496 faces), each displaced
differently, at draco_encoder's default 11/10/8 bits. K8 (`csrc/drc.cu`:
one launch a window unpacks, dequantizes and decodes the normals of
every float attribute) is held bit for bit against its twin on random
windows (every packing mode and kind, value counts off every group size,
modes 16 and 32 at their extremes, maxv 254, 0 and -1, metadata just
4-aligned, 1 to 4 components, frames that CTAs cross, attributes at every
residue mod 16, windows off a 16-byte boundary and windows whose last
16-byte piece of an attribute reaches past their end; every output view
contiguous and 16-byte aligned; a cached spec key's window one byte short
raises); `decode_drc_batch` of 8 frames on the card equals the CPU
port's bit for bit and the C host floats within 2e-5; one decode window
is one K8 launch and one H2D copy; `decode_drc_stream` at windows 4 and
8 equals the batches; device memory does not grow over the windows;
`stream_frames` runs the geometry encode over 3 windows of 32 frames.
It reports the batch and pipelined decode rates, K8 on the 8- and a
64-frame window (per call, alone, its twin; alone at 8 frames also with
the L2 cache overwritten), `stream_frames` as a median of REPS with its
minimum and maximum, beside the same windows given pinned, and the traced
split of one window.

Its last phase, `cli_player_path`, drives the port's own entry points on
the card: `uvol_tpu_torch.encoder_cli.main` in process and the facade
`Player`. Project A is the CLI's defaults (`TEMPLATE`: Draco at
11/10/8 in 8 spawned workers while CUDA is live, ETC1S at 1024/1024, 5
layers a segment) on 32 OBJ frames of 83 x 315 grids (26,145 vertices,
51,496 faces) and 32 PNG layers of 1024^2 of the bench texture, written
by this script without Pillow; project B the same inputs through `uvtg`
and `etc`. Each is encoded (A must launch K4-K7 and the segment sum, B
the minimum/maximum, K3 and K1), encoded again (no file and no mtime may
change), and played on a virtual clock at 1/60 s until the track ends,
sync and with `async_prefetch`: on every `ok` tick the geometry equals
the port's decoder's output for that frame's file, the texture layer
(`frame % 5`) the decode of that segment's file, and the async ticks the
sync ones; B's playback must launch K2. Project C (6 frames of 20 x 30
grids, 6 layers of 256^2, `uvtg` and "etc1s,etc" at 1024/1024) is encoded
on the card and on the CPU (`UVT_PLATFORM=cpu`): every file, manifest
and resume indexes included, must be the same bytes. It prints each
project's stage times, frames/s, the player's decode ms per frame and per
segment, and each kernel's launches per encode and playback, from the
wrappers' counters.

Its phase `uastc_path` runs before `cli_player_path`. U1 (the UASTC
device fit, `csrc/uastc.cu`: every candidate mode of every 4x4 block
fitted, scored and the winner chosen in one launch) is driven through
`encode_uastc_blocks(device_fit="auto")` on the bench's 32 layers of
1024^2 (2,097,152 blocks: one launch), held bit for bit against its
plain twin on the card for the default RGB pair [0, 5], for [10, 12] on
an alpha-ramp copy and for all eleven eligible modes, and timed per
call, alone and as its twin; `encode_uastc_blocks` and the legacy
`encode_uastc_ktx2` with the device fit on the card write the CPU
port's bytes (2 layers of 256^2); [0, 5] is also held and timed on
random, flat and two-colour blocks, and the kernel's nearest weight
entry (a closed form) against the twin's scan on every float32 in
[0, 64]. Project D is the CLI's `TEMPLATE` with
`TEXTURE_CODEC` "uastc" on 10 OBJ frames of 83 x 315 grids and 10
layers of 1024^2 (2 segments): encoded (the spec wire's host encode),
encoded again (nothing written), played sync and with `async_prefetch`
on the player's default ETC capabilities, where each segment becomes
etc2-eac words whose ETC1 fit is K1 (it must launch), every `ok` tick
held to the decoders' output; its segments transcoded to etc2-eac and
etc1 on the card and on the CPU give the same words.

Its phase `multidevice_path` runs after `cli_player_path`: the sequence
codecs (the bench's batch and a ragged cut of 30 frames) and the ETC1S
segment encode (256/256 and 1024/1024) with `mesh=` on ranks of
`uvol_tpu_torch.parallel` spawned as processes of their own, all on
cuda:0: one rank (a one-rank NCCL group), then 4 ranks sharing the card
over gloo (NCCL refuses two ranks on one GPU; the gathers go through
host copies). Every rank must write the one-device port's `.uvtg` and
`.ktx2` bytes and decodes, the same ETC1S bytes as every other rank and
on a rerun (one rank: the one device's bytes) within 0.5 dB of one
device's PSNR, launch K1-K6, the minimum/maximum and the segment sum,
and load nothing of JAX. It prints each rank's launches, the
rank-ordered gather and sum times, an int32 `all_reduce` over gloo on
CUDA tensors (the transport not taken) and the encodes' wall times
beside one device's: ranks sharing one card, not a scaling figure.

Its phase `pointcloud_trajectory_path` (after the UASTC device fit, before
project D: run before `profile`, it left that phase's texture-encode traces
empty five times in a row, as `cli_player_path` once did) drives
the mesh and point-cloud ops and models, whose kernels are U3-U5
(`csrc/mesh_ops.cu`): U3 (`estimate_normals`), U4 (the point-cloud
stage's quantize and Morton keys) and U5 (`parallelogram_decode`) are
held bit for bit against their twins on edge cases (-1 face
rows, isolated and degenerate faces, a vertex in 1,000 faces; coordinates
at 0 and 2^21 - 1, duplicates, N = 1 and off every CTA size; forward and
out-of-range indices, a = -1 with any b and c, values near +-2^31, 1 to 4
components, N = 1). Then, on 32 displaced 83 x 315 grids (26,145
vertices, 51,496 faces), counted from 0: `PointCloudSequenceCodec`
encode and decode (the CPU port's `.crt` bytes), `fit_trajectories`
(samples against the CPU port's), `estimate_normals` per frame, and
`parallelogram_encode`/`parallelogram_decode` of the positions at 11 bits
and the UVs at 10 with the grid's own parallelograms (the decode gives
back its input); U3, U4 and U5 must each launch. The point-cloud stage
runs again on 8 x 1,048,576 points (a captured cloud's scale). It prints
each kernel's time per call and alone, its twin's time, launches per
call, the stable sort's time beside U4's and the `.crt` host encode and
decode in seconds a frame.

Its phase `wide_palette_path` (after `pointcloud_trajectory_path`, no
trace) holds the kernels past their former limits bit for bit against
their twins: the segment sum (random and skewed), K4, K6 and K7 (with and
without a previous frame, ties at lam 0) at 2,049, 4,096 and 16,128
entries, which the segment sum and K6 take in windows of 2,048 and K7 on
its wide path; U5 at [8, 200,000, 3] and [1, 54,017, 2] (the prefix in
device memory) and at 65,536 frames, against the CPU twin. It encodes
B's segment (5 layers of 1024^2) at 4,096/4,096 endpoints and selectors:
K4-K7 and the segment sum must launch, the encode must repeat its bytes,
and the card's bytes must equal the CPU port's on the bench texture's
first 256^2 at the same widths; it prints the build and encode ms and
the wide calls' times beside their twins and bounds, which the kernels
line repeats under `wide`. Its phase `python_draco_path` encodes a short
V2 project with the CLI, rewrites its `.drc` frames with the standard
edge coder, which only the copied Python decoder takes, plays it on the
card with every `ok` tick held to the decoder's output, and times one
26,145-vertex frame's decode on the native path, the staged Python path
and the Python path alone.

Each phase prints one JSON line; then come the card's `nvidia-smi`
name/power-limit line, the kernels line (each kernel's launches on its
main path, worst difference from its twin, call time, its twin's time,
its bound: the larger of the bytes it must move over the memory rate and
its operations over the peak rate for their type; the time of the one
PyTorch call that computes the same, where there is one; its time alone,
and its registers, stack and static shared bytes), and last
`{"ok": true, "device": {...}}`.

Any failed check raises and the script exits non-zero without the last
line. So does a process that has loaded `jax` or the JAX package. Without
a CUDA card, or without the rest of the repository beside it, it exits
non-zero before printing anything on stdout.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

DEVICE = "cuda"
F, N, H, W = 32, 26145, 1024, 1024  # the bench's liam-scale batch
REPS = 5  # timed runs per number (median), after one warmup
PARITY_SIDE = 1024  # random parity inputs: one 1024^2 layer = 65,536 blocks
#: K2 on random (hostile) words at [L, H, W]: one block, one layer, widths
#: off the 16-byte store path (W % 16 != 0, one of them two runs wide), the
#: full batch
K2_RANDOM_SHAPES = ((1, 4, 4), (1, PARITY_SIDE, PARITY_SIDE), (3, 12, 20), (2, 1024, 1028),
                    (F, H, W))
#: K5 block counts held at parity, each with bases at 0, at 255 and mixed:
#: one block, and one block either side of a CTA's 128
K5_ROWS = (1, 255, 257)
ETC1S_LAYERS = 5  # the encoder CLI's KTX2_BATCH_SIZE: one segment
ETC1S_PALETTE = 256  # endpoints = selectors, encode_ktx2_etc1s's default
#: the encoder CLI's ETC1S_ENDPOINTS = ETC1S_SELECTORS (encoder_cli.py:53-57): the
#: delta-aware stage runs (512 or more), at the defaults' delta window and lambda
ETC1S_DELTA_PALETTE = 1024
ETC1S_ENTRIES = (256, 1024)  # K4 endpoints / K6 centroids held at parity
ETC1S_CPU_SIDE = 256  # the CPU comparison: 1 layer of 256x256
ETC1S_REPS = 3  # timed segment encodes (median), after the warmup
#: K4-K6 and segment-sum kernel names in a profiler trace (csrc/etc1s.cu)
ETC1S_KERNEL_NAMES = ("assign_endpoints_kernel", "inten_errors_kernel",
                      "kmeans_chunk_kernel", "seg_sum_chunk_kernel", "seg_sum_tree_kernel",
                      "rate_sweep_frame_kernel")
#: K4-K7 and the segment sum: launch-count name -> (wrapper, plain twin) in etc1s_cuda
ETC1S_KERNELS = {
    "etc1s_assign_endpoints": ("assign_endpoints", "assign_endpoints_plain"),
    "etc1s_inten_errors": ("inten_errors", "inten_errors_plain"),
    "etc1s_kmeans_iter": ("kmeans_iter", "kmeans_iter_plain"),
    "etc1s_segment_sum": ("segment_sum", "segment_sum_plain"),
    "etc1s_rate_sweep": ("rate_sweep_frame", "rate_sweep_frame_plain"),
}
#: the palette-build kernels every ETC1S encode launches (K7 only on the delta path)
ETC1S_BUILD_KERNELS = ("etc1s_assign_endpoints", "etc1s_inten_errors", "etc1s_kmeans_iter",
                       "etc1s_segment_sum")
#: kernels each wrapper launches, per call (the names of cudaFuncGetAttributes)
WRAPPER_KERNELS = {
    "etc1_encode": ("etc1_encode_kernel",),
    "etc1_decode": ("etc1_decode_kernel",),
    "quantize_delta_zigzag": ("quantize_delta_zigzag_kernel",),
    "geometry_minmax": ("geometry_minmax_kernel",),
    "etc1s_assign_endpoints": ("assign_endpoints_kernel",),
    "etc1s_inten_errors": ("inten_errors_kernel",),
    "etc1s_kmeans_iter": ("kmeans_chunk_kernel", "seg_sum_tree_kernel"),
    "etc1s_segment_sum": ("seg_sum_chunk_kernel", "seg_sum_tree_kernel"),
    "etc1s_rate_sweep": ("rate_sweep_frame_kernel",),
    "drc_fused_batch": ("drc_fused_batch_kernel",),
    "uastc_device_fit": ("uastc_device_fit_kernel",),
    "estimate_normals": ("estimate_normals_kernel",),
    "morton_keys": ("morton_keys_kernel",),
    "parallelogram_decode": ("parallelogram_decode_kernel",),
}
#: the segment sums of one palette build at 256/256 (etc1s_encode.py): (k, D)
#: of the bisections (endpoints D = 9, selectors D = 33, k doubling to 256),
#: cluster_inten, the Lloyd step and sel_update; and the largest k
SEG_SHAPES = tuple((1 << i, d) for d in (9, 33) for i in range(9)) + (
    (256, 8), (256, 4), (256, 64), (2048, 64))
#: row counts held at parity: tile and chunk edges, one N off the chunk grid
SEG_ROWS = (1, 63, 64, 65, 1025, 20000, 70001)
SEG_TIMED = (327680, 256, 64)  # sel_update's shape on the main path: N, k, D
#: rows above the 2^24 of one launch: the segment sum and K6 in two chunks
SEG_ROWS_CHUNKED = (1 << 24) + 1025
#: the palettes whose builds' segment-sum and K6 calls are replayed and timed
#: (`segment_sum_builds`): the smoke's 256/256 and the encoder CLI's 1,024/1,024
SEG_BUILD_PALETTES = (256, 1024)
#: the segment sum at sel_update's N and D on other assignments: (k, share of
#: the rows in one segment)
SEG_EXTRA = ((256, 0.0), (256, 0.9), (1024, 0.0), (1024, 0.9), (2048, 0.0))
SEG_BUILD_REPS = 3  # timed runs of each recorded call
#: K7 on random frames (block rows, block columns, entries): one column, one
#: grid row of 256, rows past a multiple of 256, a row of two column passes,
#: the largest palette, a palette under one warp's 32 entries
K7_SHAPES = ((257, 3, 512), (1, 256, 1024), (257, 1, 2048), (16, 256, 2048), (3, 300, 17),
             (64, 64, 31))
#: each K7 shape's frames: (lam, palette with duplicate entries, has a previous
#: frame, which blocks are on the uniform selector row)
K7_FRAMES = ((60.0, False, True, "mixed"), (0.0, True, True, "mixed"),
             (60.0, False, False, "mixed"), (60.0, True, True, "all"), (60.0, False, True, "none"))
#: most device kernels one frame of the rate sweep may run (K7 runs it in one)
SWEEP_FRAME_KERNELS_MAX = 5
#: the rate sweep at 1024/1024 on the smoke segment in the tree before K7 took
#: the whole frame (error product, scan and CR snap in plain torch around a
#: scan-only K7): device kernels per frame of one `rate_sweep_assignments`
#: pass and its peak memory in bytes, from examples/torch_etc1s_segment_times.py
#: on that tree (NVIDIA H100 80GB HBM3, 700 W)
SWEEP_BEFORE = {"pass_kernels_per_frame": 91.0, "pass_peak_bytes": 645410816}
#: the real-.drc decode (`drc_device_path`): grid frames of 83 x 315 vertices (the
#: bench's 26,145; 51,496 faces) at draco_encoder's default bits (-qp 11 -qt 10
#: -qn 8), made by the port's native encoder; 128 frames as bench.py streams, 32
#: of them distinct
DRC_GRID = (83, 315)
DRC_BITS = (11, 10, 8)
DRC_FRAMES = 128
DRC_DISTINCT = 32
DRC_WINDOW = 8  # decode_drc_stream's default window, and the batch decode's frames
DRC_BENCH_WINDOW = 4  # bench.py's stream window
DRC_STAGE_FRAMES = 64  # bench.py's device-stage variant: K8 on a 64-frame window
DRC_STREAM_WINDOWS = 3  # stream_frames over windows of F frames (bench.py:744-760)
#: K8 on random windows: (kind, mode, values hi) of every mode (modes 16 and 32
#: signed, at their extremes) and kind, each at nmax off every group size, off
#: and on a CTA's values (4,097 frames are crossed by CTAs, 4,096 not), with
#: maxv 254, 0 and -1 over the frames
DRC_ATTRS = ((1, 8, 1 << 8), (1, 10, 1 << 10), (1, 12, 1 << 12), (1, 16, 1 << 16),
             (1, 32, 1 << 32), (2, 8, 1 << 8), (2, 10, 1 << 10), (2, 16, 1 << 16))
DRC_NMAX = (1, 3, 1001, 4096, 4097)
#: and kind 1 at these modes with 1 to 4 components
DRC_NC_MODES = (8, 10, 12, 16, 32)
#: the encoder CLI and the player (`cli_player_path`): projects A and B take the
#: CLI's defaults (`encoder_cli.TEMPLATE`) on F OBJ frames of DRC_GRID grids and
#: F PNG layers of the bench texture, the Draco frames in 8 spawned workers, played
#: at 60 ticks a second; project C, 6 frames of 20 x 30 grids and 6 layers of
#: 256^2 through `uvtg` and both texture codecs at 1024/1024, on the card and on
#: the CPU
CLI_FRAMES = F
CLI_WORKERS = 8
CLI_TICK = 1 / 60
CLI_C_FRAMES = 6
CLI_C_GRID = (20, 30)
CLI_C_SIDE = 256
CLI_C_CODECS = "etc1s,etc"
#: UASTC (`uastc_path`): project D is the CLI's `TEMPLATE` with `TEXTURE_CODEC`
#: "uastc" (quality 0: the spec wire's host encode) on UASTC_FRAMES OBJ frames of
#: DRC_GRID grids and the bench texture's first UASTC_FRAMES layers at 1024^2, two
#: segments of 5 layers, played at CLI_TICK on the player's default (ETC)
#: capabilities, whose refit is K1; its segments transcoded on the card and on the
#: CPU (segment, target) as UASTC_CPU_TRANSCODES lists. U1 runs on the bench's F
#: layers (2,097,152 blocks) with each mode list of UASTC_MODE_SETS; the card's
#: `encode_uastc_blocks` / legacy `encode_uastc_ktx2` with the device fit against
#: the CPU port's on UASTC_CPU_LAYERS layers of UASTC_CPU_SIDE^2
UASTC_FRAMES = 10
UASTC_CPU_TRANSCODES = ((0, "etc2-eac"), (0, "etc1"), (1, "etc2-eac"), (1, "etc1"))
UASTC_MODE_SETS = {"rgb": (0, 5), "rgba": (10, 12),
                   "all": (0, 1, 2, 5, 10, 11, 12, 13, 14, 17, 18)}
UASTC_CPU_LAYERS = 2
UASTC_CPU_SIDE = 256
#: U1 at the main path's blocks and modes on four block classes (`uastc_classes`)
UASTC_CLASSES = ("bench_gradient", "random", "flat", "two_colour")
UASTC_WEIGHT_CHUNK = 1 << 25  # floats of one comparison of the closed-form weight index
#: multidevice_path: the ranks of `uvol_tpu_torch.parallel` on cuda:0 — one rank
#: (a one-rank NCCL group), then MD_SHARED ranks sharing the card over gloo (NCCL
#: refuses two ranks on one GPU); the bench's batch at full width and a ragged cut
#: that does not divide over MD_SHARED, the ETC1S segment at both palettes
MD_SHARED = 4
MD_RAGGED = 30
MD_PALETTES = (ETC1S_PALETTE, ETC1S_DELTA_PALETTE)
MD_TIMEOUT = 900  # seconds a group of ranks may take, its start and build included
#: the kernels every rank must launch on the multi-device path
MD_KERNELS = ("etc1_encode", "etc1_decode", "quantize_delta_zigzag", "geometry_minmax",
              *ETC1S_BUILD_KERNELS)
#: what `all_sum_in_rank_order` is timed on: a segment sum's partial at the
#: selector update's k and D (SEG_TIMED)
MD_SUM_SHAPE = (256, 64)
#: pointcloud_trajectory_path: the point-cloud codec, the trajectory fit, the
#: normals and the parallelogram pair on PC_FRAMES displaced DRC_GRID grids, the
#: positions and UVs quantized at PC_BITS; the point-cloud stage at a captured
#: cloud's scale (frames, points); U4 and U5 on their edge shapes: (frames,
#: points) off every CTA size, (vertices, components) of the chains
PC_FRAMES = F
PC_BITS = (11, 10)
PC_CLOUD = (8, 1 << 20)
U4_EDGE_SHAPES = ((1, 1), (3, 255), (2, 257), (1, 1000))
U5_EDGE_SHAPES = ((1, 1), (1, 2), (97, 1), (1025, 2), (2048, 3), (3001, 4))
#: wide palettes (`wide_palette_path`): the kernels past one window of the
#: segment-sum and K6 kernels (2,048 segments or centroids) and past K7's
#: register path (2,048 entries), bit for bit against their twins at
#: WIDE_ENTRIES on WIDE_ROWS rows (blocks, features) and K7 frames of
#: WIDE_K7_FRAME blocks; B's segment (ETC1S_LAYERS layers of 1024^2) built and
#: encoded at WIDE_PALETTE endpoints and selectors, whose card bytes must
#: equal the CPU port's on the bench texture's first WIDE_CPU_SIDE^2 (4,096
#: blocks: the palette is not capped); the kernels timed at WIDE_TIMED
#: entries on the main path's shapes (SEG_TIMED's rows and D, B's 327,680
#: blocks, one 1024^2 frame for K7)
WIDE_ENTRIES = (2049, 4096, 16128)
WIDE_ROWS = 65536
WIDE_K7_FRAME = (64, 256)
WIDE_PALETTE = 4096
WIDE_CPU_SIDE = 256
WIDE_TIMED = (4096, 16128)
#: U5 past one CTA's shared-memory prefix (54,016 vertices) and past one
#: launch's 65,535 frames: (frames, vertices, components), each held against
#: the CPU twin; the first is timed
U5_WIDE_SHAPES = ((8, 200000, 3), (1, 54017, 2), (65536, 3, 1))
#: `python_draco_path`: PYDRC_FRAMES OBJ frames of DRC_GRID grids and their
#: layers at PYDRC_SIDE^2 encoded by the CLI (draco + etc), the `.drc` frames
#: then rewritten with the standard edge coder, which only the copied Python
#: decoder takes, and played on the card
PYDRC_FRAMES = 4
PYDRC_SIDE = 256
#: trajectory samples on the card against the CPU port's: within this share of
#: the positions' scale (the float64 solve amplifies V^T y's float32 sum order)
TRAJ_REL_TOL = 1e-4
#: U5's dependent chain: per step two dependent shared-memory loads (the index,
#: then the prefix value) and the stored sum the next step may read, assumed
#: ~30 cycles each at the H100 SXM's 1,980 MHz boost clock
U5_STEP_CYCLES = 90
SM_CLOCK_HZ = 1.98e9
#: K3's and the minimum/maximum's kernel names in a profiler trace (csrc/geometry.cu)
K3_KERNEL_NAME = WRAPPER_KERNELS["quantize_delta_zigzag"][0]
MINMAX_KERNEL_NAME = WRAPPER_KERNELS["geometry_minmax"][0]
#: the geometry stage's two kernels, and the device kernels of one `encode_device`
STAGE_KERNEL_NAMES = (MINMAX_KERNEL_NAME, K3_KERNEL_NAME)
ENCODE_DEVICE_KERNELS = 4
#: profiler traces taken before a kernel counts as never seen: the profiler drops
#: device events now and then, and once a stage's three traces in a row
TRACE_ATTEMPTS = 5
TRACES_RETAKEN = []  # the kernels missing from each trace that was taken again
#: each trace opens with one spin kernel (torch.cuda._sleep), a synchronise and
#: a pause, and closes with another spin kernel, and the trace's readers leave
#: that kernel out: the profiler lost a device event of short traces (a K6
#: call's trace held 1 of its 2 kernels four times in a row on one H100), so
#: the first and the last event of a trace are the pads
PAD_KERNEL = "spin_kernel"
PAD_CYCLES = 1000
PAD_S = 0.01
LAUNCH_COUNT_CALLS = 3  # calls in one trace that counts a wrapper's kernels per call
K3_PROFILED_LAUNCHES = 50  # calls timed back to back, and traced for K3 alone

# The bound of a kernel: max(bytes / memory rate, operations / peak rate).
# Published peaks of the H100 SXM (NVIDIA's data sheet) at 700 W: HBM
# 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s. Integer work:
# 33.5 T instructions/s, derived, not published: the SMs dispatch at most 128
# thread-instructions per clock each (4 schedulers x 32 lanes), which is
# also what the float32 peak counts (an FFMA as 2 FLOP: 67 T / 2); an
# IMAD counts as one instruction.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT_OPS_PER_S = 67e12 / 2
#: operations per unit of work, from each kernel's arithmetic (csrc/ notes)
OPS = {
    # per 4x4 block: both flips x 8 tables, rank + refine. The least count
    # known: the static SASS of K1 (csrc/etc1.cu) with only its closed-form
    # pass 2, counted with `cuobjdump -sass` (PERF.md section 6); recount
    # it when K1 changes
    "etc1_encode": 2792,
    # per pixel: a block is ~130 instructions (header, 24 clamped values,
    # per row a selector and 9 byte permutes), counted from the source
    "etc1_decode": 8,
    # per vertex: mask select, sub, fma, floor, cvt, delta, 3 for the zigzag, a shuffle
    "quantize_delta_zigzag": 10,
    "geometry_minmax": 4,  # per vertex: two selects, min, max
    "etc1s_assign_endpoints": 256,  # per (block, endpoint): 16 px x 4 codes x (3 IMAD + min)
    # per (pixel, table) at most: 4 codes x 3 FFMA, 3 min, an add; 4 with
    # every code open. Counted code by code on the timed bases by
    # `inten_errors_ops`: recount both when K5 changes
    "etc1s_inten_errors": 16,
    "etc1s_kmeans_iter": 8,  # FLOP per (row, centroid): 4 x (mul, add)
    "etc1s_segment_sum": 1,  # FLOP per value: one add
    # per (block, entry) of the fused stage: the error (4 IMAD for the counts,
    # 6 __dp2a for the 12 color products, 1 IMAD, the conversion), the table
    # index (2) and its load, the ABOVE test (2), the FMA and the running
    # minimum's compare and 2 selects (csrc/etc1s.cu, K7)
    "etc1s_rate_sweep": 21,
    # per output float: a dequantized value is its unpack (3), the conversion
    # and one FMA; a normal's 3 floats take 2 unpacks and conversions, 2
    # divisions, the fold (~10), 3 products, 2 sums, a square root, a maximum
    # and 3 divisions (csrc/drc.cu, K8)
    "drc_fused_batch": 10,
    # per point: per coordinate a subtract, multiply, add, floor, two clamps
    # and the conversion (21); the spread of 10 bits (9) for 3 coordinates of
    # 2 words (54); the words' shifts and ors (10), the top word (9) and the
    # key (4) (csrc/mesh_ops.cu, U4)
    "morton_keys": 98,
    # per value: the a >= 0 test, 2 maxima, 3 minima, 3 loads, an add, a
    # subtract, the select and the residual's add (csrc/mesh_ops.cu, U5)
    "parallelogram_decode": 13,
}


def estimate_normals_ops(nv: int, nf: int) -> int:
    """FLOP of U3's function: per face 6 differences, 3 products and 3 FMA
    (2 each) and 3 products by the validity (18); per corner 3 adds; per
    vertex the norm (1 product, 2 FMA, a square root: 6), a compare and 3
    divisions (10)."""
    return 18 * nf + 9 * nf + 10 * nv


def uastc_fit_ops(modes) -> int:
    """Operations the UASTC device fit needs per block for the mode list
    `modes` (UastcMode rows), counted from the function (uvol_tpu's
    `_device_fit_fn` and the choice of the winner), not from U1's code.
    Per plane of cn channels: 2 per pixel channel for the minimum and
    maximum; 2 per channel for the axis and its squared length, 1 for its
    test; per pixel 2 per channel for the projection, its conversion, the
    division, 3 for the clamp and the scale by 64, and 8 for the nearest
    weight entry in closed form (every table is round(k * 64 / (L - 1)):
    scale and round, pick the neighbour on w64's side, the two distances,
    one compare and a select; U1 scans the table instead), 1 for 64 - w.
    Per mode and channel: 8 to quantize both endpoints (scale, round, clamp),
    6 more to expand them below 8 bits, 2 to widen them to 16 bits; 6 per
    pixel channel for the reconstruction, its difference and square; 3 for
    the mean (with the alpha term of an RGB mode) and 2 for the choice.
    The alpha term of the RGB modes, the same for each, once a block: 2
    per pixel and 2 for its mean."""
    ops = 0
    for m in modes:
        nc = 4 if m.cem == 12 else 3
        planes = (3, 1) if m.dual_plane else (nc,)
        ops += sum(32 * cn + 2 * cn + 1 + 16 * (2 * cn + 13) + 16 for cn in planes)
        ops += nc * (10 + (6 if m.ep_bits < 8 else 0)) + 16 * nc * 6 + 3 + 2
    return ops + (34 if any(m.cem != 12 for m in modes) else 0)


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def hold(err: dict, name: str, got, *twins) -> None:
    """Fail unless the kernel's output `got` (a tensor or a tuple of
    them) equals every twin's; keep the largest |difference| in err[name].
    int32 indices and errors, f32 sums: all exact in f64."""
    got = got if isinstance(got, tuple) else (got,)
    for tw in twins:
        tw = tw if isinstance(tw, tuple) else (tw,)
        for g, t in zip(got, tw, strict=True):
            e = float((g.cpu().double() - t.cpu().double()).abs().max())
            check(e == 0, f"{name} differs from its plain twin")
            err[name] = max(err.get(name, 0), e)


def hold_bits(torch, err: dict, name: str, got, *twins) -> None:
    """`hold`, and the float32 outputs equal bit for bit (the sign of a
    zero included)."""
    hold(err, name, got, *twins)
    got = got if isinstance(got, tuple) else (got,)
    for tw in twins:
        tw = tw if isinstance(tw, tuple) else (tw,)
        for g, t in zip(got, tw, strict=True):
            if g.dtype == torch.float32:
                check(torch.equal(g.cpu().view(torch.int32), t.cpu().view(torch.int32)),
                      f"{name}: bits differ from its plain twin's")


@contextlib.contextmanager
def recorded_etc1s_calls(k):
    """Keep (name, arguments, output) of every K4-K7 and segment-sum call
    made inside, as the encoder made it; the calls launch as they would
    without this."""
    calls = []
    saved = {fn: getattr(k, fn) for fn, _ in ETC1S_KERNELS.values()}

    def recording(name, fn):
        def call(*args):
            out = fn(*args)
            calls.append((name, args, out))
            return out
        return call

    for name, (fn, _) in ETC1S_KERNELS.items():
        setattr(k, fn, recording(name, saved[fn]))
    try:
        yield calls
    finally:
        for fn, f in saved.items():
            setattr(k, fn, f)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sweep_frame(torch, r, nby: int, nbx: int, e: int, dup: bool, prev: bool, flat: str) -> tuple:
    """K7's arguments for one random frame, before s0_index: blocks decoded
    from random (entry, selector) pairs plus noise; a palette of e entries
    (with `dup`, its second half repeats its first: ties); 8 selector rows,
    row 0 uniform (s0_index 0) and "mixed", "all" or "none" of the blocks on
    it; random incoming entries; with `prev`, a previous pair that is the
    true one for half the blocks (so CR and the snap compete)."""
    from uvol_tpu_torch.codecs.basis.etc1s_cuda import INTEN_TABLES
    from uvol_tpu_torch.codecs.basis.etc1s_encode import sweep_bits_table

    nb = nby * nbx
    c5 = r.integers(0, 32, (e, 3))
    inten = r.integers(0, 8, e)
    if dup and e > 1:
        c5[e - e // 2:], inten[e - e // 2:] = c5[:e // 2], inten[:e // 2]
    base = ((c5 << 3) | (c5 >> 2)).astype(np.int32)
    mods = np.array(INTEN_TABLES, np.int32)[inten]
    sel_cb = r.integers(0, 4, (8, 16)).astype(np.int32)
    sel_cb[0] = 2
    lo, hi = {"mixed": (0, 8), "all": (0, 1), "none": (1, 8)}[flat]
    true_ep, true_sel = r.integers(0, e, nb), r.integers(lo, hi, nb)
    col = np.clip(base[true_ep][:, None, :]
                  + mods[true_ep][np.arange(nb)[:, None], sel_cb[true_sel]][:, :, None], 0, 255)
    blocks = np.clip(col + r.integers(-3, 4, col.shape), 0, 255).astype(np.uint8)
    ep = np.where(r.random(nb) < 0.3, true_ep, r.integers(0, e, nb)).astype(np.int32)
    half = r.random(nb) < 0.5
    pair = (np.where(half, true_ep, r.integers(0, e, nb)).astype(np.int32),
            np.where(half, true_sel, r.integers(lo, hi, nb)).astype(np.int32))
    t = torch.from_numpy
    return (t(blocks), t(base), t(mods), t(sel_cb), t(sweep_bits_table(e)), t(ep),
            t(true_sel.astype(np.int32)), (t(pair[0]), t(pair[1])) if prev else None)


def to_device(args: tuple, dev) -> tuple:
    """args with every tensor, also inside a nested tuple, moved to dev."""
    return tuple(to_device(a, dev) if isinstance(a, tuple) else a.to(dev) if hasattr(a, "to")
                 else a for a in args)


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple:
    """(bound_ms, bound_by): the least time for moving `nbytes` once and
    doing `ops` operations at the card's peak rates."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def inten_errors_ops(torch, base) -> tuple:
    """(operations, open share): the operations K5 needs on these bases
    ([N, 3] int32) and the share of (block, code) pairs that clip no
    channel of the base. Per pixel and table: each pair of codes +-m is
    one FFMA where both are open, else one per open code, three per
    clipped one and a minimum; then the minimum of the pairs and the add
    (4 with every code open, `OPS["etc1s_inten_errors"]` with none)."""
    from uvol_tpu_torch.codecs.basis.etc1s_cuda import INTEN_TABLES

    mods = torch.tensor([row[2:] for row in INTEN_TABLES], device=base.device).reshape(-1)
    plus = base.max(1).values[:, None] <= 255 - mods  # [N, 16]: +m clips no channel
    minus = base.min(1).values[:, None] >= mods
    pair = torch.where(plus & minus, 1, (3 - 2 * plus.int()) + (3 - 2 * minus.int()) + 1)
    ops = 16 * int((pair.sum(1) + 2 * len(INTEN_TABLES)).sum())
    check(ops <= 16 * OPS["etc1s_inten_errors"] * len(INTEN_TABLES) * base.shape[0],
          "K5's operation count passes its most")
    return ops, float((plus.float().mean() + minus.float().mean()) / 2)


def check_no_jax_loaded() -> None:
    """The port runs without JAX: fail if this process loaded `jax` or
    the JAX package."""
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "uvol_tpu"))
    check(not loaded, f"JAX modules loaded: {loaded[:5]}")


def boundary_offsets(inv: float, max_q: int) -> np.ndarray:
    """float32 offsets whose product with `inv` lies at k + 0.5 (within 3
    ulp either side, every k < max_q), and those near k + 0.5 for k + 1 a
    power of two where one fused multiply-add and a rounded multiply
    then a rounded add give different integers (tests/
    test_torch_pallas_kernels.py builds the same set)."""
    inv = np.float32(inv)

    def fused(x):
        return np.floor((x.astype(np.float64) * np.float64(inv) + 0.5).astype(np.float32))

    def split(x):
        return np.floor((x * inv).astype(np.float32) + np.float32(0.5))

    x0 = ((np.arange(max_q, dtype=np.float64) + 0.5) / np.float64(inv)).astype(np.float32)
    parts = [(x0.view(np.int32) + d).view(np.float32) for d in range(-3, 4)]
    for e in range(int(np.log2(max_q)) + 1):
        c = np.float32((2.0 ** e - 0.5) / float(inv))
        x = (c.view(np.int32) + np.arange(-4000, 4000, dtype=np.int32)).view(np.float32)
        x = x[x >= 0]
        parts.append(x[fused(x) != split(x)])
    out = np.concatenate(parts)
    return out[(out >= 0) & (out * inv <= max_q)]


def stage_inputs(torch, positions, uvs) -> dict:
    """name -> (planar x [F, C, N], mask [F, N], bits) for the geometry
    stage: random batches with ragged masks at vertex counts on and off
    the 16-byte grid, a frame of one vertex, a frame of equal values
    (range 0 -> 1), a frame without a valid vertex, rows whose minimum is
    both zeros in both orders, and the bench batch."""
    r = np.random.default_rng(5)
    inputs = {}
    for f, c, n in ((1, 3, 1), (3, 2, 513), (4, 3, 4099), (3, 3, 4096), (2, 2, N)):
        x = (r.normal(size=(f, c, n)) * 7).astype(np.float32)
        mask = np.arange(n)[None, :] < r.integers(1, n + 1, f)[:, None]
        inputs[f"random_{f}x{c}x{n}"] = (x, mask, 11)
    f, c, n = 4, 3, 2051
    x = (np.abs(r.normal(size=(f, c, n))) + 1).astype(np.float32)
    x[0, 0, [0, n - 1]] = 0.0, -0.0  # both zeros are the minimum, either first
    x[0, 1, [7, 1030]] = -0.0, 0.0
    x[0, 2, [7, 1030]] = 0.0, 0.0
    x[1] = 2.75  # equal values
    x[2, :, 5:] = -1.0  # padded vertices below the valid ones
    counts = np.array([n, n, 5, 0])  # frame 3 has no valid vertex
    x[2, :, :5] = -0.0  # a frame whose valid values are all -0.0
    inputs["corners_4x3x2051"] = (x, np.arange(n)[None, :] < counts[:, None], 10)
    full = np.ones((F, N), bool)
    inputs["bench_positions"] = (np.ascontiguousarray(positions.transpose(0, 2, 1)), full, 11)
    inputs["bench_uvs"] = (np.ascontiguousarray(uvs.transpose(0, 2, 1)), full, 10)
    return {k: (torch.from_numpy(x), torch.from_numpy(m), b) for k, (x, m, b) in inputs.items()}


def k3_parity(torch, dev, positions, uvs) -> dict:
    """K3 and the minimum/maximum against their plain twins on the card
    (and on the CPU). The stage entry and its two halves on
    `stage_inputs`, each also from a batch 4 bytes off a 16-byte boundary
    (K3's scalar loads and stores): symbols, minimum and range bit for
    bit. K3 with its offsets given, as before: random batches,
    rounding-boundary offsets (their quantized values also held to one
    fused multiply-add), and the full positions and UVs of the bench batch
    as the geometry encode gave them."""
    from uvol_tpu_torch.ops.pallas_kernels import quantize_offsets
    from uvol_tpu_torch.ops import pallas_kernels as pk

    err, shapes = {}, {}
    for name, (x, mask, bits) in stage_inputs(torch, positions, uvs).items():
        f, c, n = x.shape
        shifted = torch.zeros(x.numel() + 1, device=dev)
        shifted[1:] = x.reshape(-1).to(dev)
        shifted = shifted[1:].view(f, c, n)
        check(shifted.data_ptr() % 16 == 4, "the shifted batch is not 4 bytes off the grid")
        md = mask.to(dev)
        small = x.numel() <= 1 << 20  # the CPU twin too, where it is quick
        twins = [pk.geometry_quantize_stage_plain(x.to(dev), md, bits)]
        twins += [pk.geometry_quantize_stage_plain(x, mask, bits)] if small else []
        for xd in (x.to(dev), shifted):
            syms, mn, rng = pk.geometry_quantize_stage(xd, md, bits)
            hold_bits(torch, err, "quantize_delta_zigzag", (syms, rng),
                      *((t[0], t[2]) for t in twins))
            hold_bits(torch, err, "geometry_minmax", mn, *(t[1] for t in twins))
            # the two halves through their own entries
            bounds = pk.geometry_minmax(xd, md)
            hold_bits(torch, err, "geometry_minmax", bounds, pk.geometry_minmax_plain(xd, md),
                      *([pk.geometry_minmax_plain(x, mask)] if small else []))
            hold_bits(torch, err, "quantize_delta_zigzag",
                      pk.quantize_from_bounds(xd, md, *bounds, bits),
                      pk.quantize_from_bounds_plain(xd, md, *bounds, bits), (syms, rng))
        shapes[name] = [f, c, n]

    r = np.random.default_rng(4)
    inputs = {}
    for f, c, n in ((1, 3, 1), (3, 2, 513), (4, 3, 4099)):
        x = torch.from_numpy((r.normal(size=(f, c, n)) * 7).astype(np.float32))
        mask = torch.from_numpy(np.arange(n)[None, :] < r.integers(1, n + 1, f)[:, None])
        inputs[f"random_{f}x{c}x{n}"] = quantize_offsets(x, 11, mask)[:2]
    invs = np.float32([1.0, 2047 / 1.7345, 1023 / 0.9871])
    rows = [boundary_offsets(inv, 2047 if i < 2 else 1023) for i, inv in enumerate(invs)]
    xb = np.zeros((len(rows), 1, max(map(len, rows))), np.float32)
    for i, row in enumerate(rows):
        xb[i, 0, : len(row)] = row
    inputs["boundary"] = (torch.from_numpy(xb), torch.from_numpy(invs))
    mask = torch.ones((F, N), dtype=torch.bool, device=dev)
    for name, a in (("bench_positions", positions), ("bench_uvs", uvs)):
        planar = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1))).to(dev)
        inputs[name] = quantize_offsets(planar, 11 if a.shape[-1] == 3 else 10, mask)[:2]
    given = {}
    for name, (xm, inv) in inputs.items():
        got = pk.fused_quantize_delta_zigzag(xm.to(dev), inv.to(dev))
        hold(err, "quantize_delta_zigzag", got,
             pk.fused_quantize_delta_zigzag_plain(xm.to(dev), inv.to(dev)),
             pk.fused_quantize_delta_zigzag_plain(xm.cpu(), inv.cpu()))
        given[name] = list(xm.shape)
    # the boundary rows' quantized values are the fused multiply-add's
    got = pk.fused_quantize_delta_zigzag(*(t.to(dev) for t in inputs["boundary"]))
    zz = got.cpu().numpy().view(np.uint32).astype(np.int64)
    q = np.cumsum(np.where(zz % 2 == 0, zz // 2, -(zz + 1) // 2), -1)
    for i, row in enumerate(rows):
        want = np.floor((row.astype(np.float64) * np.float64(invs[i]) + 0.5).astype(np.float32))
        check(bool((q[i, 0, : len(row)] == want).all()), "K3 does not round as one FMA")
    torch.cuda.synchronize()
    emit({"phase": "k3_parity", "stage_shapes": shapes, "offsets_given_shapes": given,
          "boundary_rows": [len(x) for x in rows], "max_abs_err": err})
    return err


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def bench_batch():
    """The synthetic liam-scale batch of bench.py (smooth surface, strip
    connectivity, shifted gradient texture), from default_rng(0)."""
    r = np.random.default_rng(0)
    theta = r.uniform(0, np.pi, N)
    phi = r.uniform(0, 2 * np.pi, N)
    base = np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1
    )
    positions = np.stack([base * (1 + 0.01 * k) for k in range(F)]).astype(np.float32)
    uvs = r.uniform(0, 1, (F, N, 2)).astype(np.float32)
    counts = np.full(F, N, np.int64)
    k = np.arange(2 * N - 2)
    strip = np.stack([k // 2, k // 2 + 1 + (k % 2), k // 2 + 2 - (k % 2)], 1)
    faces = [(strip % N).astype(np.int32) for _ in range(F)]
    yy, xx = np.mgrid[0:H, 0:W]
    tex = np.stack([(xx // 4) % 256, (yy // 4) % 256, ((xx + yy) // 8) % 256], -1)
    textures = np.stack([np.roll(tex, s, axis=1) for s in range(F)]).astype(np.uint8)
    return positions, uvs, counts, faces, textures


def boundary_blocks() -> np.ndarray:
    """Rounding-boundary blocks (tests/test_pallas_parity.py) and one flat
    block per value 0..255."""
    b = np.zeros((4, 4, 4, 3), np.uint8)
    b[0] = 127
    b[0, 0, 0, :] = 131
    b[1, :, :, 1] = 128
    b[3] = 255
    flat = np.broadcast_to(np.arange(256, dtype=np.uint8)[:, None, None, None],
                           (256, 4, 4, 3))
    return np.concatenate([b, flat])


def check_full_f32() -> None:
    """The port runs its f32 matmuls in full f32 (TF32 off): the ETC1S
    selector errors are integer sums below 2^24 that TF32 would round.
    The palette core makes the same check before every build."""
    from uvol_tpu_torch._device import require_full_f32

    require_full_f32()


def etc1s_parity(torch, dev, textures, bb) -> dict:
    """K4-K7 and the segment sum against their plain twins on the card
    (and on the CPU where the input is small): max_abs_err per kernel."""
    from uvol_tpu_torch.codecs.basis import etc1s_cuda as k
    from uvol_tpu_torch.codecs.basis.etc1s_encode import block_features

    r = np.random.default_rng(2)
    inputs = {
        "bench_texture_1x1024": textures[0].reshape(H // 4, 4, W // 4, 4, 3)
        .transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3),
        "random_blocks": r.integers(0, 256, ((PARITY_SIDE // 4) ** 2, 16, 3), dtype=np.uint8),
        "boundary_blocks": bb.reshape(-1, 16, 3),
    }
    err = {}
    for name, blocks_np in inputs.items():
        blocks = torch.from_numpy(np.ascontiguousarray(blocks_np))
        n = len(blocks)
        small = n < 4096  # the CPU twin too, where it is quick
        bd = blocks.to(dev)
        base = torch.from_numpy(r.integers(0, 256, (n, 3)).astype(np.int32))
        base[: min(n, 4)] = torch.tensor([[0, 0, 0], [255, 255, 255], [4, 251, 128],
                                          [251, 4, 7]])[: min(n, 4)]
        got = k.inten_errors(bd, base.to(dev))
        hold(err, "etc1s_inten_errors", got, k.inten_errors_plain(bd, base.to(dev)),
             *([k.inten_errors_plain(blocks, base)] if small else []))
        feats = block_features(bd)
        for e in ETC1S_ENTRIES:
            eb = torch.from_numpy(r.integers(0, 256, (e, 3)).astype(np.int32))
            ei = torch.from_numpy(r.integers(0, 8, e).astype(np.int32))
            eb[e - 1], ei[e - 1] = eb[0], ei[0]  # a duplicate endpoint: ties
            table = k.endpoint_table(eb, ei)
            got = k.assign_endpoints(bd, table.to(dev))
            hold(err, "etc1s_assign_endpoints", got,
                 k.assign_endpoints_plain(bd, table.to(dev)),
                 *([k.assign_endpoints_plain(blocks, table)] if small else []))
            pick = torch.from_numpy(r.integers(0, n, e)).to(dev)
            cb = feats[pick] + torch.from_numpy(r.random((e, 4)).astype(np.float32)).to(dev)
            hold(err, "etc1s_kmeans_iter", k.kmeans_iter(feats, cb),
                 k.kmeans_iter_plain(feats, cb),
                 *([k.kmeans_iter_plain(feats.cpu(), cb.cpu())] if small else []))
    # K5 off the CTA grid, with every table clipping (bases 0 and 255) and mixed
    for n in K5_ROWS:
        blocks = torch.from_numpy(r.integers(0, 256, (n, 16, 3), dtype=np.uint8))
        mixed = r.integers(0, 256, (n, 3)).astype(np.int32)
        mixed[::2] = r.integers(110, 146, (len(mixed[::2]), 3))  # tables 0..6 open
        for base in (np.zeros_like(mixed), np.full_like(mixed, 255), mixed):
            base = torch.from_numpy(base)
            hold(err, "etc1s_inten_errors", k.inten_errors(blocks.to(dev), base.to(dev)),
                 k.inten_errors_plain(blocks.to(dev), base.to(dev)),
                 k.inten_errors_plain(blocks, base))
    # the segment sum at every (k, D) of a palette build and at k = 2048, and
    # K6 at 1, 256 and 2048 centroids, over row counts at tile and chunk
    # edges; values over many magnitudes with -0.0 among them
    for n in SEG_ROWS:
        small = n <= 1025
        for kk, d in SEG_SHAPES:
            idx = torch.from_numpy(r.integers(0, kk, n).astype(np.int64))
            x = r.normal(size=(n, d)) * 10.0 ** r.integers(-3, 8, (n, d))
            x[r.random((n, d)) < 0.1] = -0.0
            x = torch.from_numpy(x.astype(np.float32))
            got = k.segment_sum(idx.to(dev), kk, x.to(dev))
            twins = [k.segment_sum_plain(idx.to(dev), kk, x.to(dev))]
            twins += [k.segment_sum_plain(idx, kk, x)] if small else []
            hold(err, "etc1s_segment_sum", got, *twins)
            for tw in twins:  # signed zeros too: the bits, not only the values
                check(torch.equal(got.cpu().view(torch.int32), tw.cpu().view(torch.int32)),
                      "segment sum bits differ from its twin's")
        feats = torch.from_numpy((r.random((n, 4)) * 255).astype(np.float32))
        for kk in (1, 256, 2048):
            cb = feats[torch.from_numpy(r.integers(0, n, kk))] + torch.from_numpy(
                r.random((kk, 4)).astype(np.float32))
            hold(err, "etc1s_kmeans_iter", k.kmeans_iter(feats.to(dev), cb.to(dev)),
                 k.kmeans_iter_plain(feats.to(dev), cb.to(dev)),
                 *([k.kmeans_iter_plain(feats, cb)] if small else []))
    # above the rows of one launch: one launch per chunk of 2^24 rows, the chunk
    # results added in the twin's order
    n = SEG_ROWS_CHUNKED
    check(n > k.SEG_MAX_ROWS, "SEG_ROWS_CHUNKED is within one launch")
    idx = torch.from_numpy(r.integers(0, 16, n).astype(np.int32)).to(dev)
    feats = torch.from_numpy(r.random((n, 4), dtype=np.float32) * 255).to(dev)
    before = dict(k.LAUNCHES)
    got = k.segment_sum(idx, 16, feats)
    tw = k.segment_sum_plain(idx, 16, feats)
    hold(err, "etc1s_segment_sum", got, tw)
    check(torch.equal(got.view(torch.int32), tw.view(torch.int32)),
          "segment sum bits differ from its twin's above 2^24 rows")
    cb = feats[torch.from_numpy(r.integers(0, n, 16)).to(dev)] + 0.5
    hold(err, "etc1s_kmeans_iter", k.kmeans_iter(feats, cb), k.kmeans_iter_plain(feats, cb))
    for name in ("etc1s_segment_sum", "etc1s_kmeans_iter"):
        check(k.LAUNCHES[name] == before[name] + 2, f"{name}: not one launch per chunk of rows")
    del idx, feats, got, tw
    # K7 on random frames: ties (duplicate entries at lambda 0), with and
    # without a previous frame, all blocks flat and none; one launch each,
    # new entries and selectors bit for bit
    for nby, nbx, e in K7_SHAPES:
        for lam, dup, prev, flat in K7_FRAMES:
            args = sweep_frame(torch, r, nby, nbx, e, dup, prev, flat) + (0, lam, 1.5, nbx)
            on_dev = to_device(args, dev)
            before = k.LAUNCHES["etc1s_rate_sweep"]
            got = k.rate_sweep_frame(*on_dev)
            check(k.LAUNCHES["etc1s_rate_sweep"] == before + 1, "K7: not one launch per frame")
            hold(err, "etc1s_rate_sweep", got, k.rate_sweep_frame_plain(*on_dev),
                 *([k.rate_sweep_frame_plain(*args)] if nby * nbx * e <= 1 << 20 else []))
    torch.cuda.synchronize()
    emit({"phase": "etc1s_kernel_parity", "inputs": list(inputs), "entries": ETC1S_ENTRIES,
          "inten_errors_rows": K5_ROWS,
          "segment_sum": {"shapes_k_d": SEG_SHAPES, "rows": SEG_ROWS},
          "kmeans_rows": SEG_ROWS, "rows_above_one_launch": SEG_ROWS_CHUNKED,
          "rate_sweep_shapes": K7_SHAPES, "rate_sweep_frames": K7_FRAMES, "max_abs_err": err})
    return err


@contextlib.contextmanager
def padded_trace(torch):
    """`device_trace` whose first and last device events are spin kernels
    (`PAD_KERNEL`), the first finished before the block runs."""
    from uvol_tpu_torch.utils.timing import device_trace

    with device_trace() as prof:
        torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        yield prof
        torch.cuda._sleep(PAD_CYCLES)


def device_events(torch, prof) -> list:
    """The device events of a finished `padded_trace`, the pads left out."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and PAD_KERNEL not in e.name]


def kernel_only_ms(torch, fn, names, reps: int = REPS) -> tuple:
    """(ms, launches traced per kernel): device time of the named kernels
    per call of fn (profiler), after one untraced call: the kernels alone,
    without the wrapper's host work. Each kernel's mean over the launches
    the trace holds, so a launch the profiler drops does not count as a
    zero; a trace that holds none of a kernel's launches is taken again
    (`TRACE_ATTEMPTS` times in all), and `TRACES_RETAKEN` counts those."""
    fn()
    for attempt in range(TRACE_ATTEMPTS):
        with padded_trace(torch) as prof:
            for _ in range(reps):
                fn()
        times = {n: [] for n in names}
        for e in device_events(torch, prof):
            for n in names:
                if n in e.name:
                    times[n].append(e.time_range.elapsed_us() / 1e3)
        if all(times.values()):
            break
        TRACES_RETAKEN.append([n for n, t in times.items() if not t])
        emit({"phase": "trace_retaken", "attempt": attempt + 1, "missing": TRACES_RETAKEN[-1]})
    check(all(times.values()), f"the profiler saw none of {[n for n, t in times.items() if not t]}")
    return sum(float(np.mean(t)) for t in times.values()), {n: len(t) for n, t in times.items()}


def launches_per_call(torch, fn, names) -> int:
    """Device kernels one call of fn runs, from a profiler trace of
    `LAUNCH_COUNT_CALLS` calls; fails if the trace holds a device event
    of another name. A trace in which some name of `names` is not seen
    a nonzero multiple of the calls' number of times has lost events,
    and is taken again like `kernel_only_ms`'s, `TRACE_ATTEMPTS` times
    in all."""
    fn()
    for attempt in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        with padded_trace(torch) as prof:
            for _ in range(LAUNCH_COUNT_CALLS):
                fn()
        kernels = [e.name for e in device_events(torch, prof)]
        seen = {n: sum(n in kn for kn in kernels) for n in names}
        short = [n for n, c in seen.items() if c == 0 or c % LAUNCH_COUNT_CALLS]
        if not short:
            break
        TRACES_RETAKEN.append(short)
        emit({"phase": "trace_retaken", "attempt": attempt + 1, "missing": short,
              "seen": seen})
    check(not short, f"the profiler lost launches of {short} in every trace: {seen}")
    check(all(any(n in kn for n in names) for kn in kernels),
          f"unexpected device events: {[kn[:60] for kn in kernels]}")
    return len(kernels) // LAUNCH_COUNT_CALLS


def etc1s_main_path(torch, textures) -> tuple:
    """`encode_ktx2_etc1s` on one segment at full width: launches, byte
    determinism, every K4-K6 call of the encode against its twin on the
    same inputs, transcoded PSNR, the quality floor's rebuilds, and the
    CPU port at 1 layer of 256x256. Returns (launches, max_abs_err, the
    blocks and bases of the encode's first K5 call)."""
    from uvol_tpu_torch.codecs.basis import etc1s_cuda as k
    from uvol_tpu_torch.codecs.basis.etc1s_encode import (
        encode_ktx2_etc1s, read_ktx2, transcode_ktx2_etc1s)

    frames = textures[:ETC1S_LAYERS]
    kw = dict(num_endpoints=ETC1S_PALETTE, num_selectors=ETC1S_PALETTE)
    encode_ktx2_etc1s(frames[:1, :256, :256], device=DEVICE, **kw)  # warmup
    torch.cuda.synchronize()
    k.reset_launches()
    t = time.perf_counter()
    blob = encode_ktx2_etc1s(frames, device=DEVICE, **kw)
    first_s = time.perf_counter() - t
    launches = dict(k.LAUNCHES)
    for name in ETC1S_BUILD_KERNELS:
        check(launches[name] >= 1, f"the ETC1S main path never launched {name}")
    check(launches["etc1s_rate_sweep"] == 0, "K7 ran below 512 endpoints")
    # every palette build runs K5 three times (cluster_inten)
    builds = launches["etc1s_inten_errors"] // 3
    # the second encode keeps each kernel call's inputs (the real blocks,
    # endpoint tables and centroids, with their near-ties) and output
    with recorded_etc1s_calls(k) as calls:
        again = encode_ktx2_etc1s(frames, device=DEVICE, **kw)
    check(again == blob, "two CUDA encodes of one segment gave different bytes")
    err = {}
    replayed = {name: {"calls": 0, "shapes": []} for name in ETC1S_KERNELS}
    for name, args, out in calls:
        hold(err, name, out, getattr(k, ETC1S_KERNELS[name][1])(*args))
        rec = replayed[name]
        shapes = [list(a.shape) if hasattr(a, "shape") else a for a in args]
        rec["calls"] += 1
        if shapes not in rec["shapes"]:
            rec["shapes"].append(shapes)
    for name, rec in replayed.items():
        check(rec["calls"] == launches[name], f"{name}: calls differ between two encodes")
    inten_args = next(args for name, args, _ in calls if name == "etc1s_inten_errors")
    dec = transcode_ktx2_etc1s(read_ktx2(blob))[..., :3]
    check(dec.shape == frames.shape and dec.dtype == np.uint8, "transcoded shape")
    mse = float(((dec.astype(np.float64) - frames) ** 2).mean())
    psnr = 10 * np.log10(255.0**2 / mse)
    check(np.isfinite(psnr) and psnr >= 24.0, f"ETC1S PSNR {psnr:.2f} dB")

    small = np.ascontiguousarray(frames[:1, :ETC1S_CPU_SIDE, :ETC1S_CPU_SIDE])
    t = time.perf_counter()
    cpu_blob = encode_ktx2_etc1s(small, device="cpu", **kw)
    cpu_s = time.perf_counter() - t
    cuda_blob = encode_ktx2_etc1s(small, device=DEVICE, **kw)
    same = cpu_blob == cuda_blob

    def small_psnr(b):
        out = transcode_ktx2_etc1s(read_ktx2(b))[..., :3].astype(np.float64)
        return 10 * np.log10(255.0**2 / float(((out - small) ** 2).mean()))

    p_cpu, p_cuda = small_psnr(cpu_blob), small_psnr(cuda_blob)
    check(same or (abs(p_cpu - p_cuda) <= 0.05
                   and abs(len(cpu_blob) - len(cuda_blob)) <= 0.01 * len(cpu_blob)),
          "CUDA and CPU ETC1S encodes differ beyond quality parity")
    emit({"phase": "etc1s_main_path", "layers": ETC1S_LAYERS, "size": [H, W],
          "palette": ETC1S_PALETTE, "launches": launches, "ktx2_bytes": len(blob),
          "transcoded_psnr_db": psnr, "lam_ladder_builds": builds,
          "first_encode_s": first_s, "deterministic": True,
          "calls_vs_twin": {"max_abs_err": err, "calls": replayed},
          "cpu_compare": {"size": [ETC1S_CPU_SIDE] * 2, "bytes_equal": same,
                          "cpu_bytes": len(cpu_blob), "cuda_bytes": len(cuda_blob),
                          "cpu_psnr_db": p_cpu, "cuda_psnr_db": p_cuda, "cpu_s": cpu_s}})
    return launches, err, inten_args


def etc1s_times(torch, dev, textures, inten_args, median_cuda_ms) -> tuple:
    """K4-K6 and their twins at the main path's shapes (5 x 1024^2 =
    327,680 blocks, 256 entries), each output held against its twin's; K5
    on `inten_args`, the blocks and bases of a segment encode's own call
    (its work depends on the bases), and held also on random bases and
    with every base at 0 and at 255; the palette core on device-resident
    blocks, the palette build and the segment encode, host-inclusive.
    Returns (ms, max_abs_err, K5's operations on the timed bases)."""
    from uvol_tpu_torch.codecs.basis import etc1s_cuda as k
    from uvol_tpu_torch.codecs.basis.etc1s_encode import (
        _blocks_of, block_features, build_palettes, encode_ktx2_etc1s, palette_core)

    frames = textures[:ETC1S_LAYERS]
    bd = torch.from_numpy(_blocks_of(frames)).to(dev)
    n = len(bd)
    r = np.random.default_rng(3)
    feats = block_features(bd)
    cb = feats[torch.from_numpy(r.integers(0, n, ETC1S_PALETTE)).to(dev)]
    eb = torch.from_numpy(r.integers(0, 256, (ETC1S_PALETTE, 3)).astype(np.int32)).to(dev)
    ei = torch.from_numpy(r.integers(0, 8, ETC1S_PALETTE).astype(np.int32)).to(dev)
    table = k.endpoint_table(eb, ei)
    base = eb[k.kmeans_iter(feats, cb)[2].long()]
    sn, sk, sd = SEG_TIMED
    traced = {}  # launches the profiler held per kernel, of REPS calls
    seg_idx = torch.from_numpy(r.integers(0, sk, sn).astype(np.int32)).to(dev)
    seg_x = torch.from_numpy(r.integers(-400, 400, (sn, sd)).astype(np.float32)).to(dev)
    ms, err = {}, {}
    check(tuple(inten_args[0].shape) == tuple(bd.shape), "the encode's K5 call is not full size")
    for other in (base, torch.zeros_like(base), torch.full_like(base, 255)):
        hold(err, "etc1s_inten_errors", k.inten_errors(bd, other),
             k.inten_errors_plain(bd, other))
    inten_ops, inten_open = inten_errors_ops(torch, inten_args[1])
    for name, args in (("etc1s_assign_endpoints", (bd, table)),
                       ("etc1s_inten_errors", inten_args),
                       ("etc1s_kmeans_iter", (feats, cb)),
                       ("etc1s_segment_sum", (seg_idx, sk, seg_x))):
        kernel, twin = (getattr(k, fn) for fn in ETC1S_KERNELS[name])
        hold(err, name, kernel(*args), twin(*args))
        ms[name] = median_cuda_ms(lambda: kernel(*args), REPS)
        ms[name + "_plain"] = median_cuda_ms(lambda: twin(*args), REPS)
        ms[name + "_kernel"], traced[name] = kernel_only_ms(
            torch, lambda: kernel(*args), WRAPPER_KERNELS[name])
    # K5 alone again with the 50 MB L2 cache overwritten before each call: its
    # 30 MB of inputs stay in the cache between the repeated calls above,
    # and do not between the calls of a palette build
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def inten_cold():
        flush.zero_()
        return k.inten_errors(*inten_args)

    ms["etc1s_inten_errors_kernel_l2_cold"], _ = kernel_only_ms(
        torch, inten_cold, WRAPPER_KERNELS["etc1s_inten_errors"])
    del flush
    # the library's call for the same sums, in no fixed order (so the port
    # does not use it): exact here, the values being small integers
    def library():
        return torch.zeros((sk, sd), device=dev).index_add_(0, seg_idx, seg_x)

    library_err = float((library() - k.segment_sum_plain(seg_idx, sk, seg_x)).abs().max())
    ms["etc1s_segment_sum_library"] = median_cuda_ms(library, REPS)
    # a K6 call and a segment-sum call launch a fixed number of kernels,
    # whatever N (the int32 indices need no conversion kernel)
    per_call = {
        f"{name}@{rows}": launches_per_call(torch, fn, WRAPPER_KERNELS[name])
        for rows in (1025, n)
        for name, fn in (("etc1s_kmeans_iter", lambda: k.kmeans_iter(feats[:rows], cb)),
                         ("etc1s_segment_sum",
                          lambda: k.segment_sum(seg_idx[:rows], sk, seg_x[:rows])))
    }
    check(set(per_call.values()) == {2}, f"kernel launches per call: {per_call}")
    # the encode, and the two stages inside it: the device-resident palette
    # core, and the build (upload, core, refine, fetch, host relabel)
    kw = dict(num_endpoints=ETC1S_PALETTE, num_selectors=ETC1S_PALETTE, device=DEVICE)
    ms["etc1s_palette_core"] = median_cuda_ms(
        lambda: palette_core(bd, ETC1S_PALETTE, ETC1S_PALETTE, 6), ETC1S_REPS)
    ms["etc1s_build_palettes"] = median_cuda_ms(
        lambda: build_palettes(frames, ETC1S_PALETTE, ETC1S_PALETTE, device=DEVICE),
        ETC1S_REPS, warmup=0)
    ms["etc1s_segment_encode"] = median_cuda_ms(lambda: encode_ktx2_etc1s(frames, **kw),
                                                ETC1S_REPS, warmup=0)
    emit({"phase": "etc1s_times", "blocks": n, "entries": ETC1S_PALETTE, "reps": REPS,
          "segment_sum_shape": SEG_TIMED, "kernels_per_call": per_call,
          "kernel_launches_traced": traced,
          "inten_errors_open_share": inten_open, "inten_errors_ops_per_block": inten_ops / n,
          "max_abs_err": err, "segment_sum_library_max_abs_err": library_err, "ms": ms,
          "segment_layers_per_s": ETC1S_LAYERS / (ms["etc1s_segment_encode"] / 1e3)})
    return ms, err, inten_ops


def segment_sum_builds(torch, dev, textures, median_cuda_ms) -> tuple:
    """Every segment-sum and K6 call of one palette build at each of
    `SEG_BUILD_PALETTES` on the smoke segment (327,680 blocks), recorded as
    `palette_core` makes them: each held bit for bit against its twin and
    timed per call (CUDA events) and alone (profiler), with the sums of the
    alone times per build; then the segment sum at sel_update's N and D on
    `SEG_EXTRA` (random and skewed assignments, k up to 2,048), its two
    kernels also apart, and the registers, stack and shared memory of the
    segment sum's and K6's kernels (pass 1's dynamic bytes those of the
    main path's shape). Returns (max_abs_err, ms)."""
    from uvol_tpu_torch import _build
    from uvol_tpu_torch.codecs.basis import etc1s_cuda as k
    from uvol_tpu_torch.codecs.basis.etc1s_encode import _blocks_of, palette_core

    bd = torch.from_numpy(_blocks_of(textures[:ETC1S_LAYERS])).to(dev)
    err, ms, builds = {}, {}, {}
    for palette in SEG_BUILD_PALETTES:
        with recorded_etc1s_calls(k) as calls:
            palette_core(bd, palette, palette, 6)
        rows, alone = [], {"etc1s_segment_sum": 0.0, "etc1s_kmeans_iter": 0.0}
        for name, args, got in calls:
            if name not in alone:
                continue
            kernel, twin = (getattr(k, fn) for fn in ETC1S_KERNELS[name])
            hold_bits(torch, err, name, got, twin(*args))
            kernel_ms, _ = kernel_only_ms(torch, lambda: kernel(*args), WRAPPER_KERNELS[name],
                                          SEG_BUILD_REPS)
            alone[name] += kernel_ms
            shape = ({"k": args[1], "d": args[2].shape[1]} if name == "etc1s_segment_sum"
                     else {"k": args[1].shape[0]})
            rows.append({"name": name, **shape, "kernel_ms": kernel_ms,
                         "ms": median_cuda_ms(lambda: kernel(*args), SEG_BUILD_REPS)})
        builds[f"{palette}/{palette}"] = {
            "alone_ms_sum": alone, "calls": rows,
            "launches": {n: sum(row["name"] == n for row in rows) for n in alone}}
        for n, v in alone.items():
            ms[f"{n}_build_{palette}_kernel_sum"] = v
        del calls
    sn, _, sd = SEG_TIMED
    r = np.random.default_rng(13)
    x = torch.from_numpy(r.integers(-400, 400, (sn, sd)).astype(np.float32)).to(dev)
    names = WRAPPER_KERNELS["etc1s_segment_sum"]
    extra = {}
    for kk, hot in SEG_EXTRA:
        idx = np.where(r.random(sn) < hot, kk // 3, r.integers(0, kk, sn))
        idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
        hold_bits(torch, err, "etc1s_segment_sum", k.segment_sum(idx, kk, x),
                  k.segment_sum_plain(idx, kk, x))
        fn = lambda: k.segment_sum(idx, kk, x)  # noqa: E731
        extra[f"k{kk}_hot{round(hot * 100)}"] = {
            "ms": median_cuda_ms(fn, REPS), "kernel_ms": kernel_only_ms(torch, fn, names)[0],
            "per_kernel_ms": {n: kernel_only_ms(torch, fn, (n,))[0] for n in names}}
    k.segment_sum(idx[:0].new_zeros(sn), SEG_TIMED[1], x)  # pass 1's shared bytes at this shape
    torch.cuda.synchronize()
    attrs = _build.kernel_attrs()
    attrs = {n: attrs[n] for n in (*names, "seg_sum_tree_kernel_small",
                                   *WRAPPER_KERNELS["etc1s_kmeans_iter"])}
    for n in (*names, "seg_sum_tree_kernel_small"):
        check(attrs[n]["stack_bytes"] == 0, f"{n} uses stack memory")
    emit({"phase": "segment_sum_builds", "blocks": len(bd), "builds": builds,
          "rows": sn, "d": sd, "extra": extra, "kernel_attrs": attrs, "max_abs_err": err})
    return err, ms


@contextlib.contextmanager
def timed_calls(torch, module, names):
    """Wrap module.<name> for each name so that every call synchronises the
    card before and after it and adds its host-clock ms to the dict
    yielded (calls counted under "<name>_calls")."""
    spent = {}
    saved = {n: getattr(module, n) for n in names}

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + (time.perf_counter() - t) * 1e3
            spent[name + "_calls"] = spent.get(name + "_calls", 0) + 1
            return out
        return call

    for n, fn in saved.items():
        setattr(module, n, timed(n, fn))
    try:
        yield spent
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def sweep_pass(torch, dev, frames, e_n: int, frame_args: tuple, median_cuda_ms) -> dict:
    """The device side of the rate sweep at 1024/1024 on the smoke segment:
    the device kernels of one sweep frame (one `etc1s_cuda.rate_sweep_frame`
    call as `rate_sweep_assignments` makes it, at most
    `SWEEP_FRAME_KERNELS_MAX`), and over one `rate_sweep_assignments` pass
    on the segment's built palette its device kernels per frame, its peak
    memory above what was allocated before it (which must stay under one
    [nb, E] float32 tile) and its time; each beside the figure of the tree
    before K7 took the whole frame (`SWEEP_BEFORE`).

    K7's launches are counted by its wrapper (`LAUNCHES`), every other
    device kernel from a padded trace of the same calls: on the H100
    machine the profiler dropped one of three K7 events in each of five
    traces in a row, so a trace decides only what else runs."""
    from uvol_tpu_torch.codecs.basis import etc1s_cuda as k
    from uvol_tpu_torch.codecs.basis import etc1s_encode as enc

    name = WRAPPER_KERNELS["etc1s_rate_sweep"][0]

    def kernels(fn, calls: int) -> dict:
        fn()
        torch.cuda.synchronize()
        before = k.LAUNCHES["etc1s_rate_sweep"]
        with padded_trace(torch) as prof:
            for _ in range(calls):
                fn()
        seen = [e.name for e in device_events(torch, prof) if not e.name.startswith("Mem")]
        launched = k.LAUNCHES["etc1s_rate_sweep"] - before
        others = [kn for kn in seen if name not in kn]
        return {"per_call": (launched + len(others)) / calls, "k7_launches": launched,
                "k7_events_traced": len(seen) - len(others),
                "names": sorted({kn[:60] for kn in seen})}

    frame = kernels(lambda: k.rate_sweep_frame(*frame_args), LAUNCH_COUNT_CALLS)
    check(frame["k7_launches"] == LAUNCH_COUNT_CALLS, "K7: not one launch per sweep frame")
    check(frame["per_call"] <= SWEEP_FRAME_KERNELS_MAX,
          f"one sweep frame ran {frame['per_call']} device kernels")
    nby, nbx = frames.shape[1] // 4, frames.shape[2] // 4
    dev_blocks = torch.from_numpy(enc._blocks_of(frames)).to(dev)
    pal = enc.build_palettes(frames, e_n, e_n, delta_window=16, device=DEVICE)

    def one_pass():
        enc.rate_sweep_assignments(copy.deepcopy(pal), nby, nbx, dev_blocks=dev_blocks,
                                   lam_bits=60.0, lam_cr=1.5)

    one_pass()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    one_pass()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    tile = nby * nbx * e_n * 4
    check(peak < tile, f"a sweep's peak memory {peak} bytes reaches an [nb, E] float32 tile")
    whole = kernels(one_pass, 1)
    check(whole["k7_launches"] == len(frames), "K7: not one launch per frame of a sweep")
    return {"frame_kernels": frame["per_call"], "frame_trace": frame,
            "pass_kernels_per_frame": whole["per_call"] / len(frames), "pass_trace": whole,
            "pass_peak_bytes": peak, "tile_bytes": tile, "before": SWEEP_BEFORE,
            "ms": median_cuda_ms(one_pass, REPS)}


def etc1s_delta_path(torch, dev, textures, median_cuda_ms) -> tuple:
    """`encode_ktx2_etc1s` on the segment (5 x 1024^2) at the encoder CLI's
    1024/1024 palettes and the defaults' delta window and lambda: launches
    (K7 once per frame of each of the 3 sweeps of every build with a delta
    lambda), byte determinism, every K4-K7 and segment-sum call of the
    second encode against its twin, transcoded PSNR, the CPU port at
    1 RGBA layer of 256^2, the encode's time with the delta stage split
    into flips, sweeps and relabels, and K7 per call, alone and its twin
    on the encode's own first call. Returns (launches, max_abs_err, ms)."""
    from uvol_tpu_torch.codecs.basis import etc1s_cuda as k
    from uvol_tpu_torch.codecs.basis import etc1s_encode as enc

    frames = textures[:ETC1S_LAYERS]
    kw = dict(num_endpoints=ETC1S_DELTA_PALETTE, num_selectors=ETC1S_DELTA_PALETTE)
    enc.encode_ktx2_etc1s(frames[:2, :256, :256], device=DEVICE, **kw)  # warmup, K7 included
    torch.cuda.synchronize()
    k.reset_launches()
    t = time.perf_counter()
    blob = enc.encode_ktx2_etc1s(frames, device=DEVICE, **kw)
    first_s = time.perf_counter() - t
    launches = dict(k.LAUNCHES)
    for name, v in launches.items():
        check(v >= 1, f"the ETC1S delta path never launched {name}")
    builds = launches["etc1s_inten_errors"] // 3
    delta_builds = min(builds, 3)  # the floor's last rung (delta lambda 0) has no delta stage
    check(launches["etc1s_rate_sweep"] == 3 * len(frames) * delta_builds,
          f"K7 launches {launches['etc1s_rate_sweep']}: not one per frame of each sweep")
    with recorded_etc1s_calls(k) as calls:
        again = enc.encode_ktx2_etc1s(frames, device=DEVICE, **kw)
    check(again == blob, "two CUDA encodes of one segment at 1024/1024 gave different bytes")
    err = {}
    replayed = {name: 0 for name in ETC1S_KERNELS}
    for name, args, out in calls:
        hold(err, name, out, getattr(k, ETC1S_KERNELS[name][1])(*args))
        replayed[name] += 1
    check(replayed == launches, f"calls differ between two encodes: {replayed}")
    # a frame of the encode with a previous one (e_prev and the snap run)
    sweep_args = next(args for name, args, _ in calls
                      if name == "etc1s_rate_sweep" and args[7] is not None)
    e_n = min(ETC1S_DELTA_PALETTE, frames.size // 48)
    check(tuple(sweep_args[0].shape) == ((H // 4) * (W // 4), 16, 3) and len(sweep_args[1]) == e_n,
          "the encode's K7 call is not one full frame")
    dec = enc.transcode_ktx2_etc1s(enc.read_ktx2(blob))[..., :3]
    check(dec.shape == frames.shape and dec.dtype == np.uint8, "transcoded shape")
    psnr = 10 * np.log10(255.0**2 / float(((dec.astype(np.float64) - frames) ** 2).mean()))
    check(np.isfinite(psnr) and psnr >= 24.0, f"ETC1S PSNR at 1024/1024 {psnr:.2f} dB")

    # the CPU port against the card on one RGBA layer of 256^2 (8,192 blocks)
    side = ETC1S_CPU_SIDE
    yy, xx = np.mgrid[0:side, 0:side]
    alpha = ((3 * xx + yy) % 256).astype(np.uint8)[None, ..., None]
    small = np.concatenate([frames[:1, :side, :side], alpha], -1)
    t = time.perf_counter()
    cpu_blob = enc.encode_ktx2_etc1s(small, device="cpu", **kw)
    cpu_s = time.perf_counter() - t
    cuda_blob = enc.encode_ktx2_etc1s(small, device=DEVICE, **kw)
    same = cpu_blob == cuda_blob

    def small_psnr(b):
        out = enc.transcode_ktx2_etc1s(enc.read_ktx2(b)).astype(np.float64)
        return 10 * np.log10(255.0**2 / float(((out - small) ** 2).mean()))

    p_cpu, p_cuda = small_psnr(cpu_blob), small_psnr(cuda_blob)
    check(same or (abs(p_cpu - p_cuda) <= 0.05
                   and abs(len(cpu_blob) - len(cuda_blob)) <= 0.01 * len(cpu_blob)),
          "CUDA and CPU ETC1S encodes at 1024/1024 differ beyond quality parity")

    # times: the encode, one more with the delta stage's passes timed apart
    ms = {"etc1s_delta_segment_encode": median_cuda_ms(
        lambda: enc.encode_ktx2_etc1s(frames, device=DEVICE, **kw), ETC1S_REPS, warmup=0)}
    with timed_calls(torch, enc, ("delta_bias_assignments", "rate_sweep_assignments",
                                  "reorder_endpoint_palette")) as split:
        torch.cuda.synchronize()
        t = time.perf_counter()
        enc.encode_ktx2_etc1s(frames, device=DEVICE, **kw)
        torch.cuda.synchronize()
        split["segment_encode"] = (time.perf_counter() - t) * 1e3
    ms["etc1s_rate_sweep"] = median_cuda_ms(lambda: k.rate_sweep_frame(*sweep_args), REPS)
    ms["etc1s_rate_sweep_plain"] = median_cuda_ms(
        lambda: k.rate_sweep_frame_plain(*sweep_args), REPS)
    ms["etc1s_rate_sweep_kernel"], traced = kernel_only_ms(
        torch, lambda: k.rate_sweep_frame(*sweep_args), WRAPPER_KERNELS["etc1s_rate_sweep"])
    # the one piece of the stage a library call computes: the error product
    # [nb, 16] x [16, E] at full float32, on the same frame
    _, feat, mat = k.sweep_features(*sweep_args[:4], sweep_args[6])
    ms["etc1s_rate_sweep_library"] = median_cuda_ms(lambda: feat @ mat.T, REPS)
    del feat, mat
    sweep = sweep_pass(torch, dev, frames, e_n, sweep_args, median_cuda_ms)
    ms["etc1s_rate_sweep_pass"] = sweep.pop("ms")
    emit({"phase": "etc1s_delta_path", "layers": ETC1S_LAYERS, "size": [H, W],
          "palette": ETC1S_DELTA_PALETTE, "launches": launches, "lam_ladder_builds": builds,
          "delta_builds": delta_builds, "ktx2_bytes": len(blob), "transcoded_psnr_db": psnr,
          "first_encode_s": first_s, "deterministic": True,
          "calls_vs_twin": {"max_abs_err": err, "calls": replayed},
          "cpu_compare": {"size": [side, side], "channels": 4, "bytes_equal": same,
                          "cpu_bytes": len(cpu_blob), "cuda_bytes": len(cuda_blob),
                          "cpu_psnr_db": p_cpu, "cuda_psnr_db": p_cuda, "cpu_s": cpu_s},
          "ms": ms, "delta_stage_ms": split, "rate_sweep_launches_traced": traced,
          "rate_sweep": sweep,
          "segment_layers_per_s": ETC1S_LAYERS / (ms["etc1s_delta_segment_encode"] / 1e3)})
    return launches, err, ms


def drc_window(torch, attrs, f: int, nmax: int, seed: int, maxv=(254.0,), pad: int = 0,
               lead: int = 0):
    """A random packed K8 window: attrs [(kind, mode, values hi[, nc])],
    kind 1 with nc (default 3) components, kind 2 (normals) with 2; mode 16
    and 32 values signed, with both extremes present; `maxv` cycles over
    the frames; `lead` bytes before the first attribute, `pad` extra bytes
    before the 4-aligned metadata. Returns (packed uint8 tensor, specs,
    meta_off, meta_len)."""
    from uvol_tpu_torch.models.drc_device import _pack_host

    r = np.random.default_rng(seed)
    chunks, metas, specs = [np.full(lead, 0xA5, np.uint8)], [], []
    off, moff = lead, 0
    for t, (kind, mode, hi, *nc) in enumerate(attrs):
        nc = nc[0] if nc else 3 if kind == 1 else 2
        n = f * nmax * nc
        lo = -(hi // 2) if mode in (16, 32) else 0
        ints = r.integers(lo, lo + hi, n, dtype=np.int64)
        ints[:2] = lo, lo + hi - 1
        by = _pack_host(ints, mode)
        meta = (np.concatenate([r.normal(size=f * nc) * 5, r.uniform(1e-4, 1e-2, f)])
                if kind == 1 else np.resize(np.asarray(maxv, np.float64), f))
        specs.append((t, kind, mode, f, nmax, nc, off, len(meta), moff))
        chunks.append(by)
        metas.append(meta.astype(np.float32))
        off += len(by)
        moff += len(meta)
    pad += (-(off + pad)) % 4
    meta_all = np.concatenate(metas)
    packed = np.concatenate(chunks + [np.zeros(pad, np.uint8), meta_all.view(np.uint8)])
    return torch.from_numpy(packed), tuple(specs), off + pad, len(meta_all)


def drc_cases(torch) -> list:
    """K8's random windows beyond `DRC_ATTRS` x `DRC_NMAX`: [(name, packed
    on the host, specs, meta_off, meta_len, base)], base the residue mod 16
    of the window's first byte on the card (`on_card_at`): kind 1 with 1 to
    4 components, the attribute at a residue mod 16; four attributes with
    the first at every residue; one frame of normals whose last 16-byte
    piece reaches past the window's end."""
    cases = []
    for mode in DRC_NC_MODES:
        for nc in range(1, 5):
            for nmax in DRC_NMAX:
                lead = (mode * 7 + nc * 3 + nmax) % 16
                packed, specs, mo, ml = drc_window(torch, [(1, mode, 1 << min(mode, 31), nc)], 3,
                                                   nmax, mode + nc + nmax, lead=lead)
                cases.append((f"nc{nc}_mode{mode}_nmax{nmax}", packed, specs, mo, ml,
                              (4 - mo) % 4 + 4 * (nmax % 4)))
    for lead in range(16):
        packed, specs, mo, ml = drc_window(
            torch, [(1, 12, 1 << 12), (1, 10, 1 << 10, 2), (2, 8, 255), (1, 16, 1 << 16, 4)],
            2, 4096, lead, pad=lead % 4, lead=lead)
        for base in ((4 - mo) % 4, (4 - mo) % 4 + 8):
            cases.append((f"four_lead{lead}_base{base}", packed, specs, mo, ml, base))
    for nmax in (1001, 1003):
        for base in range(0, 16, 4):
            packed, specs, mo, ml = drc_window(torch, [(2, 8, 255)], 1, nmax, nmax + base)
            cases.append((f"ends_in_metadata_nmax{nmax}_base{base}", packed, specs, mo, ml, base))
    return cases


def on_card_at(torch, dev, packed, base: int):
    """The window on the card as a view whose first byte lies `base` bytes
    past a 16-byte boundary (the caching allocator's blocks are 512-aligned)."""
    big = torch.zeros(len(packed) + 32, dtype=torch.uint8, device=dev)
    view = big[base:base + len(packed)]
    view.copy_(packed.to(dev))
    check(view.data_ptr() % 16 == base, "on_card_at: the view is not where it was asked")
    return view


def hold_floats(torch, err: dict, name: str, got, want) -> None:
    """Float32 tensors equal bit for bit, NaN positions included (NaN
    payloads aside); the worst |difference| of the rest in err[name]."""
    g, w = got.cpu(), want.cpu()
    check(g.shape == w.shape and g.dtype == w.dtype == torch.float32, f"{name}: shape or type")
    gn, wn = torch.isnan(g), torch.isnan(w)
    check(torch.equal(gn, wn), f"{name}: NaN positions differ from its plain twin's")
    check(torch.equal(g[~gn].view(torch.int32), w[~wn].view(torch.int32)),
          f"{name}: bits differ from its plain twin's")
    e = float((g[~gn].double() - w[~wn].double()).abs().max()) if (~gn).any() else 0.0
    err[name] = max(err.get(name, 0.0), e)


def hold_drc_batch(torch, err: dict, got, want) -> None:
    """Two DeviceFrameBatch equal: faces, counts, num_points, integer
    attributes, and every float of the padded arrays bit for bit."""
    check(got.num_points == want.num_points, ".drc batch: num_points differ")
    check(len(got.faces) == len(want.faces) and
          all(np.array_equal(a, b) for a, b in zip(got.faces, want.faces)),
          ".drc batch: faces differ")
    check(sorted(got.values) == sorted(want.values), ".drc batch: attribute sets differ")
    for t, w in want.values.items():
        check(np.array_equal(got.counts[t], want.counts[t]), f".drc batch: counts of {t}")
        if isinstance(w, list):
            check(all(np.array_equal(a, b) for a, b in zip(got.values[t], w)),
                  f".drc batch: integer attribute {t} differs")
        else:
            hold_floats(torch, err, "drc_fused_batch", got.values[t], w)


@contextlib.contextmanager
def recorded_drc_windows(dd):
    """Keep the arguments (packed window on the card, specs, meta_off,
    meta_len) of every K8 call made inside; the calls launch as usual."""
    calls = []
    saved = dd.fused_batch

    def call(*args):
        calls.append(args)
        return saved(*args)

    dd.fused_batch = call
    try:
        yield calls
    finally:
        dd.fused_batch = saved


def drc_window_trace(torch, dd, fn) -> dict:
    """The work one decode window puts on the card, from a padded trace of
    `LAUNCH_COUNT_CALLS` calls of fn: the kernel launches and copies the
    host issued (the runtime calls in the trace, the two pads left out;
    K8's also by its wrapper), the device events, and the window's split
    between host and device. The trace is taken again, up to
    `TRACE_ATTEMPTS`, while its device events hold fewer copies than calls
    or no K8: the profiler drops device events now and then (late in a
    smoke run all of one trace's copies, five times in a row). Where no
    trace holds them all, the split is None; the issued counts decide."""
    k8 = WRAPPER_KERNELS["drc_fused_batch"][0]
    calls = LAUNCH_COUNT_CALLS
    fn()
    for attempt in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        before = dd.LAUNCHES["drc_fused_batch"]
        with padded_trace(torch) as prof:
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        launched = dd.LAUNCHES["drc_fused_batch"] - before
        issued = {"launches": -2, "copies": 0, "memsets": 0}  # the two pad kernels
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CPU:
                for key, api in (("launches", "LaunchKernel"), ("copies", "Memcpy"),
                                 ("memsets", "Memset")):
                    issued[key] += e.name.startswith(("cuda", "cu")) and api in e.name
        events = [(e.name, e.time_range.elapsed_us() / 1e3) for e in device_events(torch, prof)]
        h2d = [v for n, v in events if n.startswith("Memcpy HtoD")]
        k8_ms = [v for n, v in events if k8 in n]
        missing = (["Memcpy HtoD"] if len(h2d) < calls else []) + ([] if k8_ms else [k8])
        if not missing:
            break
        TRACES_RETAKEN.append(missing)
        emit({"phase": "trace_retaken", "attempt": attempt + 1, "missing": missing,
              "issued": issued})
    others = [(n, v) for n, v in events if not n.startswith("Memcpy HtoD") and k8 not in n]
    split = None
    if not missing:
        busy = sum(h2d) + float(np.mean(k8_ms)) * launched + sum(v for _n, v in others)
        split = {"wall_ms": wall / calls, "h2d_ms": sum(h2d) / calls,
                 "k8_ms": float(np.mean(k8_ms)),
                 "other_ms": sum(v for _n, v in others) / calls,
                 "device_busy_share": busy / wall, "host_ms": (wall - busy) / calls}
    return {"kernels_per_window": issued["launches"] / calls,
            "copies_per_window": issued["copies"] / calls,
            "memsets_per_window": issued["memsets"] / calls, "k8_launches": launched,
            "device_events": {"h2d": len(h2d), "k8": len(k8_ms),
                              "others": [n[:60] for n, _v in others]},
            "split": split}


def drc_device_path(torch, dev, positions, uvs, median_cuda_ms) -> tuple:
    """The real-`.drc` device decode at liam scale (`models/drc_device.py`,
    `runtime/device_stream.py`): K8 against its twin on random windows;
    then the main path, `decode_drc_batch` of `DRC_WINDOW` frames and
    `decode_drc_stream` over `DRC_FRAMES` at its default window, with
    K8's launches counted; card = CPU; the C host floats; one window = one
    K8 and one H2D copy; the stream at windows 4 and 8 = the batches; no
    memory growth over windows; `stream_frames` through `encode_device`;
    rates, K8 on a 64-frame window, and the traced split of one window.
    Returns (launches, max_abs_err, ms, the main-path window's K8 args)."""
    from uvol_tpu_torch import native
    from uvol_tpu_torch.codecs.draco.grid import grid_drc
    from uvol_tpu_torch.models import drc_device as dd
    from uvol_tpu_torch.models.sequence import encode_device
    from uvol_tpu_torch.runtime.device_stream import stream_frames

    err = {"drc_fused_batch": 0.0}
    # K8 bit for bit on random windows
    cases = 0
    for (kind, mode, hi) in DRC_ATTRS:
        for nmax in DRC_NMAX:
            packed, specs, mo, ml = drc_window(torch, [(kind, mode, hi)], 3, nmax,
                                               mode + nmax, maxv=(254.0, 0.0, -1.0))
            got = dd.fused_batch(packed.to(dev), specs, mo, ml)
            for g, w, w2 in zip(got, dd.fused_batch_plain(packed.to(dev), specs, mo, ml),
                                dd.fused_batch_plain(packed, specs, mo, ml)):
                hold_floats(torch, err, "drc_fused_batch", g, w)
                hold_floats(torch, err, "drc_fused_batch", g, w2)
            cases += 1
    for pad in range(4):  # four attributes a launch, metadata just 4-aligned
        packed, specs, mo, ml = drc_window(torch, [(1, 12, 1 << 11), (1, 10, 1 << 10),
                                                   (2, 8, 255), (1, 16, 1 << 16)],
                                           DRC_WINDOW, 4097, pad, pad=pad)
        for g, w in zip(dd.fused_batch(packed.to(dev), specs, mo, ml),
                        dd.fused_batch_plain(packed.to(dev), specs, mo, ml)):
            hold_floats(torch, err, "drc_fused_batch", g, w)
        cases += 1
    # component counts, offsets and window bases; every output view contiguous
    # and 16-byte aligned
    for _name, packed, specs, mo, ml, base in drc_cases(torch):
        for g, w in zip(dd.fused_batch(on_card_at(torch, dev, packed, base), specs, mo, ml),
                        dd.fused_batch_plain(packed, specs, mo, ml), strict=True):
            check(g.is_contiguous() and g.data_ptr() % 16 == 0,
                  "K8's output view is not contiguous and 16-byte aligned")
            hold_floats(torch, err, "drc_fused_batch", g, w)
        cases += 1
    # the plan cache: a hit and a miss on a new meta_len give a fresh call's
    # outputs; a window one byte short of a cached key raises
    packed, specs, mo, ml = drc_window(torch, [(1, 12, 1 << 11), (2, 8, 255)], DRC_WINDOW,
                                       4096, 7)
    dd._PLANS.clear()
    fresh = dd.fused_batch(packed.to(dev), specs, mo, ml)
    hit = dd.fused_batch(on_card_at(torch, dev, packed, 4), specs, mo, ml)
    longer = torch.cat([packed, torch.zeros(4, dtype=torch.uint8)])
    miss = dd.fused_batch(longer.to(dev), specs, mo, ml + 1)
    check(len(dd._PLANS) == 2, f"K8's plan cache holds {len(dd._PLANS)} keys, not 2")
    for a, b, c in zip(fresh, hit, miss, strict=True):
        hold_floats(torch, err, "drc_fused_batch", b, a)
        hold_floats(torch, err, "drc_fused_batch", c, a)
    try:
        dd.fused_batch(packed.to(dev)[:-1], specs, mo, ml)
        check(False, "K8 took a window one byte short of its cached key")
    except ValueError:
        pass

    # frames: liam-scale grids from the port's native encoder, before any timing
    t = time.perf_counter()
    distinct = [grid_drc(*DRC_GRID, seed, DRC_BITS) for seed in range(DRC_DISTINCT)]
    blobs = [distinct[i % DRC_DISTINCT] for i in range(DRC_FRAMES)]
    encode_s = time.perf_counter() - t
    first = blobs[:DRC_WINDOW]

    # the main path, its K8 launches counted
    dd.decode_drc_batch(first)  # warmup: pinned pool, side stream
    torch.cuda.synchronize()
    dd.reset_launches()
    batch = dd.decode_drc_batch(first)
    windows = 0
    for _start, _b in dd.decode_drc_stream(blobs):
        windows += 1
    torch.cuda.synchronize()
    launches = {"drc_fused_batch": dd.LAUNCHES["drc_fused_batch"]}
    check(launches["drc_fused_batch"] == 1 + windows,
          f"K8: {launches['drc_fused_batch']} launches for {1 + windows} windows")

    # card = CPU, bit for bit; the C host floats within 2e-5
    hold_drc_batch(torch, err, batch, dd.decode_drc_batch(first, device="cpu"))
    host_err = 0.0
    for i, blob in enumerate(first):
        full = native.drc_decode_native(blob)
        for a in full[3]:
            n = len(a[5])
            got = batch.values[a[0]][i, :n].cpu().numpy()
            check(np.allclose(got, a[5], rtol=2e-5, atol=2e-5),
                  f".drc attribute {a[0]} of frame {i} is off the C host floats")
            host_err = max(host_err, float(np.abs(got - a[5]).max()))
    check(all(bool(torch.isfinite(v).all()) for v in batch.values.values()),
          "non-finite decoded values")
    check(tuple(batch.values[0].shape) == (DRC_WINDOW, dd._bucket(DRC_GRID[0] * DRC_GRID[1]), 3),
          "decoded positions shape")

    # one window: one K8 launch and one H2D copy, nothing else on the card
    events = drc_window_trace(torch, dd, lambda: dd.decode_drc_batch(first))
    check(events["k8_launches"] == LAUNCH_COUNT_CALLS and events["kernels_per_window"] == 1
          and events["copies_per_window"] == 1 and events["memsets_per_window"] == 0
          and not events["device_events"]["others"], f"a decode window's device work: {events}")

    # the stream at bench.py's window 4 and at the default 8: every window is
    # the batch of its slice (the frames repeat every DRC_DISTINCT)
    for window in (DRC_BENCH_WINDOW, DRC_WINDOW):
        want = {}
        for start, b in dd.decode_drc_stream(blobs, window=window):
            key = start % DRC_DISTINCT
            if key not in want:
                want[key] = dd.decode_drc_batch(blobs[start:start + window])
            hold_drc_batch(torch, err, b, want[key])
        del want

    # device memory does not grow with the number of windows: the peak over
    # one stream of DRC_FRAMES frames at its DRC_DISTINCT-th frame and at its end
    def drain(frames):
        for _s, _b in dd.decode_drc_stream(frames, window=DRC_BENCH_WINDOW):
            pass
        torch.cuda.synchronize()

    drain(blobs[:DRC_DISTINCT])
    torch.cuda.reset_peak_memory_stats()
    peaks = {}
    for start, _b in dd.decode_drc_stream(blobs, window=DRC_BENCH_WINDOW):
        if start + DRC_BENCH_WINDOW == DRC_DISTINCT:
            peaks[DRC_DISTINCT] = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    peaks[DRC_FRAMES] = torch.cuda.max_memory_allocated()
    window_out = DRC_BENCH_WINDOW * sum(v.shape[1] * v.shape[2] * 4
                                        for v in batch.values.values())
    check(peaks[DRC_FRAMES] <= peaks[DRC_DISTINCT] + window_out,
          f"device memory grew with the windows: {peaks}")

    # stream_frames over 3 windows of 32 frames through the geometry encode
    pos_t = np.ascontiguousarray(positions.transpose(0, 2, 1))
    uv_t = np.ascontiguousarray(uvs.transpose(0, 2, 1))
    sf_windows = [(pos_t, uv_t, np.ones((F, N), bool)) for _ in range(DRC_STREAM_WINDOWS)]
    sf_want = encode_device(*(torch.from_numpy(a).to(dev) for a in sf_windows[0]), 11, 10)
    step = lambda w: encode_device(*w, 11, 10)  # noqa: E731
    sf_seen = 0
    for _i, out in stream_frames(sf_windows, step):
        check(all(torch.equal(out[k], v) for k, v in sf_want.items()),
              "stream_frames' windowed encode differs from the unwindowed one")
        sf_seen += 1
    check(sf_seen == DRC_STREAM_WINDOWS, "stream_frames yielded the wrong number of windows")

    # rates: the batch decode (host-inclusive), the pipelined stream (median of 3)
    def host_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    ms = {}
    verts = int(sum(batch.counts[0]))
    ms["drc_decode_batch"] = float(np.median([host_ms(lambda: dd.decode_drc_batch(first))
                                              for _ in range(REPS)]))
    ms["drc_decode_pipelined"] = float(np.median([host_ms(lambda: drain(blobs))
                                                  for _ in range(3)]))
    # stream_frames: REPS runs on the numpy windows (each array pinned on its
    # upload), beside the same windows given already pinned
    sf_pinned = [tuple(torch.from_numpy(a).pin_memory() for a in w) for w in sf_windows]
    sf = {}
    for key, wins in (("numpy", sf_windows), ("pinned", sf_pinned)):
        runs = [host_ms(lambda: [r for _i, r in stream_frames(wins, step)])
                for _ in range(REPS)]
        sf[key] = {"median_ms": float(np.median(runs)), "min_ms": min(runs),
                   "max_ms": max(runs), "runs_ms": runs}
    sf_ms = sf["numpy"]["median_ms"]
    del sf_pinned

    # K8 at the main path's window (DRC_WINDOW frames) and at the bench's
    # 64-frame device stage: per call, alone, and its twin on the card
    with recorded_drc_windows(dd) as rec:
        dd.decode_drc_batch(first)
        dd.decode_drc_batch(blobs[:DRC_STAGE_FRAMES])
    main_args, stage_args = rec
    k8 = WRAPPER_KERNELS["drc_fused_batch"]
    for key, args in (("drc_fused_batch", main_args), ("drc_fused_batch_64", stage_args)):
        for g, w in zip(dd.fused_batch(*args), dd.fused_batch_plain(*args)):
            hold_floats(torch, err, "drc_fused_batch", g, w)
        ms[key] = median_cuda_ms(lambda: dd.fused_batch(*args), REPS)
        ms[key + "_plain"] = median_cuda_ms(lambda: dd.fused_batch_plain(*args), REPS)
        ms[key + "_kernel"], _ = kernel_only_ms(torch, lambda: dd.fused_batch(*args), k8)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def k8_cold():  # the 50 MB L2 cache overwritten before each call
        flush.zero_()
        return dd.fused_batch(*main_args)

    ms["drc_fused_batch_kernel_l2_cold"], _ = kernel_only_ms(torch, k8_cold, k8)
    del flush
    stage_verts = DRC_STAGE_FRAMES * DRC_GRID[0] * DRC_GRID[1]

    emit({"phase": "drc_device_path", "grid": DRC_GRID, "bits": DRC_BITS,
          "frames": DRC_FRAMES, "distinct": DRC_DISTINCT, "encode_s": encode_s,
          "blob_bytes": sum(map(len, distinct)) / DRC_DISTINCT,
          "k8_random_cases": cases, "launches": launches, "window": events,
          "host_c_max_abs_err": host_err, "peak_bytes": peaks, "window_out_bytes": window_out,
          "packed_bytes": {"main": int(main_args[0].numel()), "stage": int(stage_args[0].numel())},
          "ms": ms, "stream_frames_ms": sf_ms, "stream_frames": sf,
          "decode_fps": DRC_WINDOW / (ms["drc_decode_batch"] / 1e3),
          "decode_mverts": verts / (ms["drc_decode_batch"] / 1e3) / 1e6,
          "decode_pipelined_fps": DRC_FRAMES / (ms["drc_decode_pipelined"] / 1e3),
          "stage_mverts": stage_verts / (ms["drc_fused_batch_64"] / 1e3) / 1e6,
          "stage_mverts_kernel": stage_verts / (ms["drc_fused_batch_64_kernel"] / 1e3) / 1e6,
          "stream_frames_fps": DRC_STREAM_WINDOWS * F / (sf_ms / 1e3),
          "max_abs_err": err})
    return launches, err, ms, main_args

# ---------------------------------------------------------------------------
# The encoder CLI and the V2 player (`cli_player_path`)
# ---------------------------------------------------------------------------


def grid_parallelograms(ny: int, nx: int) -> np.ndarray:
    """[ny * nx, 3] int32: the grid's own parallelograms, (i - 1, i - nx,
    i - nx - 1) for the vertex (r, c) = divmod(i, nx) with r, c >= 1, else
    -1 (the previous vertex predicts)."""
    i = np.arange(ny * nx)
    inner = (i >= nx) & (i % nx >= 1)
    return np.where(inner[:, None], np.stack([i - 1, i - nx, i - nx - 1], 1), -1).astype(np.int32)


def mesh_op_cases(r) -> tuple:
    """The edge cases U3-U5 are held on: (U3 meshes, U4 batches, U5 chains),
    each a dict of name -> numpy arguments."""
    from uvol_tpu_torch.codecs.draco.grid import grid_mesh

    pos, _, _, faces = grid_mesh(7, 9, 0)
    u3 = {
        "minus_one_rows_isolated_degenerate": (
            np.concatenate([pos, r.normal(size=(4, 3)).astype(np.float32)]),
            np.concatenate([faces, np.full((5, 3), -1), [[3, 3, 3], [2, 4, 2], [0, 1, 1]]]
                           ).astype(np.int32)),
        # vertex 0 in 1,000 faces, in every corner position in turn
        "vertex_in_1000_faces": (
            r.normal(size=(1002, 3)).astype(np.float32) * 100,
            np.array([np.roll([0, j + 1, j + 2], j % 3) for j in range(1000)], np.int32)),
        "random_shared": (r.normal(size=(60, 3)).astype(np.float32),
                          r.integers(0, 60, (4000, 3)).astype(np.int32)),
    }
    u4 = {}
    for f, n in U4_EDGE_SHAPES:
        x = (r.normal(size=(f, n, 3)) * 30).astype(np.float32)
        u4[f"random_{f}x{n}"] = (x, 11)
        u4[f"duplicates_{f}x{n}"] = (r.integers(0, 4, (f, n, 3)).astype(np.float32), 11)
    corners = np.zeros((1, 8, 3), np.float32)
    corners[0, 1:] = [[1, 1, 1], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [0.5, 0.5, 0.5],
                      [1, 0, 1]]
    u4["coordinates_0_and_2^21-1"] = (corners, 21)
    u5 = {}
    for n, d in U5_EDGE_SHAPES:
        res = r.integers(-(1 << 31), (1 << 31) - 1, (2, n, d), dtype=np.int64)
        near = np.array([(1 << 31) - 1, -(1 << 31), (1 << 31) - 2, -(1 << 31) + 1])
        res[:, : min(n, 4)] = near[: min(n, 4), None]  # values near +-2^31
        i = np.arange(n)
        a = np.where(r.random((2, n)) < 0.2, -1, i - r.integers(-3, 5, (2, n)))  # forward too
        b = np.where(r.random((2, n)) < 0.1, n - 1, i - r.integers(-2, 6, (2, n)))
        c = np.where(r.random((2, n)) < 0.1, 0, i + r.integers(-5, 40, (2, n)))  # past N too
        u5[f"chain_{n}x{d}"] = (res.astype(np.int32), np.stack([a, b, c], -1).astype(np.int32))
    return u3, u4, u5


def same_bits(torch, err: dict, name: str, got, want) -> None:
    """Fail unless the kernel's output equals its twin's bit for bit (float32
    as int32 bits, the sign of a zero included; int64 keys as they are)."""
    got, want = got.cpu(), want.cpu()
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    check(got.shape == want.shape and torch.equal(got, want), f"{name} differs from its plain twin")
    err[name] = max(err.get(name, 0), 0.0)


def pointcloud_trajectory_path(torch, dev, median_cuda_ms) -> tuple:
    """U3-U5 and the point-cloud and trajectory models at full width: the
    kernels held bit for bit against their twins on the edge cases, then the
    main paths on PC_FRAMES displaced DRC_GRID grids (point-cloud encode and
    decode against the CPU port's bytes, the trajectory fit against the CPU
    port's, normals per frame, parallelogram encode and decode of the
    quantized positions and UVs), the point-cloud stage at a captured
    cloud's scale, and the times. Returns (launches, err, ms, work)."""
    from uvol_tpu_torch.codecs.draco.grid import grid_mesh
    from uvol_tpu_torch.models import trajectory as ttraj
    from uvol_tpu_torch.models.pointcloud import PointCloudSequenceCodec
    from uvol_tpu_torch.ops import mesh_cuda as mc
    from uvol_tpu_torch.ops.prediction import parallelogram_decode, parallelogram_encode
    from uvol_tpu_torch.ops.quantize import compute_quantization_transform, quantize
    from uvol_tpu_torch._device import true_div

    t0 = time.perf_counter()
    r = np.random.default_rng(15)
    err, ms = {}, {}
    td = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    def inv_of(x, bits):
        mn, rng = compute_quantization_transform(x)
        return mn, true_div(1.0, true_div(rng, (1 << bits) - 1))

    # ---- the edge cases: each kernel on the card against its twin (U4's on the
    # card; U3's and U5's, loops of many small launches, on the CPU)
    u3, u4, u5 = mesh_op_cases(r)
    for name, (p, f) in u3.items():
        same_bits(torch, err, "estimate_normals", mc.estimate_normals(td(p), td(f)),
                  mc.estimate_normals_plain(torch.from_numpy(p), torch.from_numpy(f)))
    for name, (x, bits) in u4.items():
        xd = td(x)
        mn, inv = inv_of(xd, bits)
        if name.startswith("coordinates"):
            mn, inv = torch.zeros_like(mn), torch.full_like(inv, float((1 << 21) - 1))
        keys = mc.morton_keys(xd, mn, inv, bits)
        same_bits(torch, err, "morton_keys", keys, mc.morton_keys_plain(xd, mn, inv, bits))
        if name.startswith("coordinates"):
            check(int(keys.max()) == (1 << 63) - 1 and int(keys.min()) == 0,
                  "the Morton key at coordinates 0 and 2^21 - 1")
    for name, (res, p) in u5.items():
        same_bits(torch, err, "parallelogram_decode", mc.parallelogram_decode(td(res), td(p)),
                  mc.parallelogram_decode_plain(torch.from_numpy(res), torch.from_numpy(p)))
    edge_s = time.perf_counter() - t0

    # ---- the main paths at full width, counted from 0
    ny, nx = DRC_GRID
    grids = [grid_mesh(ny, nx, 1000 + k) for k in range(PC_FRAMES)]
    pos = np.stack([g[0] for g in grids])
    uvs = np.stack([g[1] for g in grids])
    faces = grids[0][3]
    check(all(np.array_equal(g[3], faces) for g in grids), "the grids' faces differ")
    nv, nf = pos.shape[1], len(faces)
    pos_d, uv_d, faces_d = td(pos), td(uvs), td(faces)
    pidx = td(np.broadcast_to(grid_parallelograms(ny, nx), (PC_FRAMES, nv, 3)))
    codec = PointCloudSequenceCodec(PC_BITS[0], device=DEVICE)
    codec.decode(codec.encode(pos[:1]))  # warm: the host Corto library's build (g++) and load
    mc.reset_launches()
    t = time.perf_counter()
    blobs = codec.encode(pos)
    crt_encode_s = time.perf_counter() - t
    t = time.perf_counter()
    decoded = codec.decode(blobs)
    crt_decode_s = time.perf_counter() - t
    group = ttraj.fit_trajectories(pos, 4, device=DEVICE)
    normals = [mc.estimate_normals(pos_d[k], faces_d) for k in range(PC_FRAMES)]
    q_pos = quantize(pos_d, PC_BITS[0]).values
    q_uv = quantize(uv_d, PC_BITS[1]).values
    res_pos = parallelogram_encode(q_pos, pidx)
    res_uv = parallelogram_encode(q_uv, pidx)
    back_pos = parallelogram_decode(res_pos, pidx)
    back_uv = parallelogram_decode(res_uv, pidx)
    torch.cuda.synchronize()
    launches = dict(mc.LAUNCHES)
    check(launches == {"estimate_normals": PC_FRAMES, "morton_keys": 1,
                       "parallelogram_decode": 2},
          f"the point-cloud, trajectory, normals and parallelogram paths launched {launches}")

    # their outputs: the CPU port's bytes and values, the kernels' twins
    cpu_codec = PointCloudSequenceCodec(PC_BITS[0], device="cpu")
    check(cpu_codec.encode(pos) == blobs, ".crt bytes differ between CUDA and CPU")
    sorted_cpu, _ = cpu_codec.device_stage(torch.from_numpy(pos))
    step = float(max((pos[k].max(0) - pos[k].min(0)).max() for k in range(PC_FRAMES))) / 2047
    for k, d in enumerate(decoded):
        check(d.shape == (nv, 3) and bool(np.isfinite(d).all()), "decoded point cloud shape")
        check(float(np.abs(d - sorted_cpu[k].numpy()).max()) <= step, "decoded points off by a step")
    pos_cpu = torch.from_numpy(pos)
    mn, inv = inv_of(pos_d, PC_BITS[0])
    same_bits(torch, err, "morton_keys", mc.morton_keys(pos_d, mn, inv, PC_BITS[0]),
              mc.morton_keys_plain(pos_cpu, *inv_of(pos_cpu, PC_BITS[0]), PC_BITS[0]))
    cpu_group = ttraj.fit_trajectories(pos, 4, device="cpu")
    vty = ttraj._vty(pos_d, 4).double().cpu()
    vty_cpu = ttraj._vty(pos_cpu, 4).double()
    vand = ttraj.vandermonde(PC_FRAMES, 4, torch.device("cpu")).double().abs()
    mag = vand.t() @ pos_cpu.reshape(PC_FRAMES, -1).double().abs()
    eps = float(np.finfo(np.float32).eps)
    check(bool(((vty - vty_cpu).abs() <= 2 * PC_FRAMES * eps * mag).all()),
          "V^T y on the card is off the CPU's by more than float32 summation error")
    scale = float(np.abs(pos).max())
    traj_err = max(float(np.abs(group.sample(k) - cpu_group.sample(k)).max())
                   for k in (0, PC_FRAMES // 2, PC_FRAMES - 1, 7.5))
    check(traj_err <= TRAJ_REL_TOL * scale, f"trajectory samples off the CPU port's by {traj_err}")
    fit_err = ttraj.reconstruction_error(pos, group)
    for k in range(PC_FRAMES):
        same_bits(torch, err, "estimate_normals", normals[k],
                  mc.estimate_normals_plain(pos_cpu[k], torch.from_numpy(faces)))
        nn = normals[k].cpu().norm(dim=1)
        check(bool(((nn - 1).abs() < 1e-5).all()), "normals are not unit vectors")
    check(torch.equal(back_pos, q_pos) and torch.equal(back_uv, q_uv),
          "the parallelogram decode did not give back its input")
    for back, res in ((back_pos, res_pos), (back_uv, res_uv)):
        same_bits(torch, err, "parallelogram_decode", back,
                  mc.parallelogram_decode_plain(res.cpu(), pidx.cpu()))

    # ---- a captured cloud's scale: the point-cloud stage on PC_CLOUD points
    fc, ncl = PC_CLOUD
    gen = torch.Generator(device=dev).manual_seed(15)
    cloud = torch.randn((fc, ncl, 3), generator=gen, device=dev) * 2.0
    mc.reset_launches()
    sorted_cloud, perm = codec.device_stage(cloud)
    torch.cuda.synchronize()
    check(mc.LAUNCHES["morton_keys"] == 1, "the captured cloud's stage did not launch U4 once")
    cmn, cinv = inv_of(cloud, PC_BITS[0])
    ckeys = mc.morton_keys(cloud, cmn, cinv, PC_BITS[0])
    same_bits(torch, err, "morton_keys", ckeys, mc.morton_keys_plain(cloud, cmn, cinv, PC_BITS[0]))
    check(bool((ckeys.gather(1, perm.long()).diff(dim=1) >= 0).all()), "the cloud is not sorted")
    check(torch.equal(perm[0].cpu(), cpu_codec.device_stage(cloud[0:1].cpu())[1][0]),
          "the captured cloud's order differs between CUDA and CPU")

    # ---- times: per call (CUDA events), alone (profiler), twin, library
    p0 = pos_d[0]
    fn3 = mc.face_normals_plain(p0, faces_d).repeat(3, 1)
    corners = faces_d.t().reshape(-1).long()
    acc = torch.zeros_like(p0)
    calls = {
        "estimate_normals": (lambda: mc.estimate_normals(p0, faces_d),
                             lambda: mc.estimate_normals_plain(p0, faces_d)),
        "morton_keys": (lambda: mc.morton_keys(cloud, cmn, cinv, PC_BITS[0]),
                        lambda: mc.morton_keys_plain(cloud, cmn, cinv, PC_BITS[0])),
        "morton_keys_grid": (lambda: mc.morton_keys(pos_d, mn, inv, PC_BITS[0]),
                             lambda: mc.morton_keys_plain(pos_d, mn, inv, PC_BITS[0])),
        "parallelogram_decode": (lambda: mc.parallelogram_decode(res_pos, pidx), None),
        "parallelogram_decode_uv": (lambda: mc.parallelogram_decode(res_uv, pidx), None),
    }
    kernel_of = {"estimate_normals": "estimate_normals_kernel",
                 "morton_keys": "morton_keys_kernel", "morton_keys_grid": "morton_keys_kernel",
                 "parallelogram_decode": "parallelogram_decode_kernel",
                 "parallelogram_decode_uv": "parallelogram_decode_kernel"}
    per_call = {}
    for key, (fn, twin) in calls.items():
        mc.reset_launches()
        fn()
        per_call[key] = sum(mc.LAUNCHES.values())
        ms[key] = median_cuda_ms(fn, REPS)
        if twin is not None:
            ms[key + "_plain"] = median_cuda_ms(twin, REPS)
        ms[key + "_kernel"], _ = kernel_only_ms(torch, fn, (kernel_of[key],))
    ms["estimate_normals_library"] = median_cuda_ms(
        lambda: acc.index_add_(0, corners, fn3), REPS)  # index_add_ of the corner normals
    ms["estimate_normals_csr"] = median_cuda_ms(lambda: mc.normals_csr(faces_d, nv), REPS)
    ms["morton_keys_sort"] = median_cuda_ms(lambda: torch.sort(ckeys, dim=-1, stable=True), REPS)
    ms["morton_keys_grid_sort"] = median_cuda_ms(
        lambda: torch.sort(mc.morton_keys(pos_d, mn, inv, PC_BITS[0]), dim=-1, stable=True), REPS)
    ms["pointcloud_device_stage_cloud"] = median_cuda_ms(lambda: codec.device_stage(cloud), REPS)
    ms["trajectory_vty"] = median_cuda_ms(lambda: ttraj._vty(pos_d, 4), REPS)
    ms["parallelogram_encode"] = median_cuda_ms(lambda: parallelogram_encode(q_pos, pidx), REPS)
    # last, after this phase's traces: U5's twin on the card, a Python loop of
    # ~300,000 small launches, timed once
    t = time.perf_counter()
    twin_pos = mc.parallelogram_decode_plain(res_pos, pidx)
    torch.cuda.synchronize()
    ms["parallelogram_decode_plain"] = (time.perf_counter() - t) * 1e3
    same_bits(torch, err, "parallelogram_decode", back_pos, twin_pos)
    emit({"phase": "pointcloud_trajectory_path", "frames": PC_FRAMES, "vertices": nv,
          "faces": nf, "cloud": [fc, ncl], "launches": launches,
          "launches_per_call": per_call, "crt_bytes": sum(map(len, blobs)),
          "crt_encode_s_per_frame": crt_encode_s / PC_FRAMES,
          "crt_decode_s_per_frame": crt_decode_s / PC_FRAMES,
          "trajectory_sample_max_abs_diff_vs_cpu": traj_err,
          "trajectory_fit_max_abs_error": fit_err, "edge_cases_s": edge_s,
          "edge_cases": {"u3": list(u3), "u4": list(u4), "u5": list(u5)},
          "ms": ms, "seconds": time.perf_counter() - t0})
    work = {"nv": nv, "nf": nf, "cloud": (fc, ncl), "chain": (PC_FRAMES, nv, 3)}
    return launches, err, ms, work


def u5_chain(r, f: int, n: int, d: int) -> tuple:
    """Residuals [f, n, d] and index triples [f, n, 3] of a U5 chain: a
    the previous vertex mostly, else random earlier ones, forward
    references (which read 0) and a = -1 rows."""
    i = np.arange(n)
    a = np.where(r.random((f, n)) < 0.6, i - 1, i - r.integers(1, 1 << 16, (f, n)))
    a = np.where(r.random((f, n)) < 0.05, -1, np.where(r.random((f, n)) < 0.01, i + 3, a))
    b, c = i - r.integers(1, 1 << 12, (f, n)), i - r.integers(-2, 1 << 12, (f, n))
    p = np.stack([a, np.maximum(b, -1), c], -1).astype(np.int32)
    res = r.integers(-(1 << 12), 1 << 12, (f, n, d)).astype(np.int32)
    return res, p


def once_ms(torch, fn) -> float:
    """Host-clock ms of one call of `fn` to the end of its device work: for
    the twins, too slow to repeat."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def wide_palette_path(torch, dev, textures, median_cuda_ms) -> tuple:
    """The segment sum, K6 and K7 past one window (2,048) and U5 past its
    shared prefix and one launch's frames: each bit for bit against its
    twin; B's segment built and encoded at WIDE_PALETTE/WIDE_PALETTE on the
    card (K4-K7 and the segment sum must launch), its bytes against the CPU
    port's on a smaller segment at the same widths; the wide calls timed
    beside their twins and bounds. Returns (err, ms, wide, launches)."""
    from uvol_tpu_torch import _build
    from uvol_tpu_torch.codecs.basis import etc1s_cuda as k
    from uvol_tpu_torch.codecs.basis.etc1s_encode import (
        build_palettes, encode_ktx2_etc1s, read_ktx2, transcode_ktx2_etc1s)
    from uvol_tpu_torch.ops import mesh_cuda as mc

    t0 = time.perf_counter()
    r = np.random.default_rng(16)
    err, ms, wide = {}, {}, {}
    sn, _sk, sd = SEG_TIMED

    # ---- parity at every wide width
    blocks = torch.from_numpy(r.integers(0, 256, (WIDE_ROWS, 16, 3), dtype=np.uint8)).to(dev)
    feats = torch.from_numpy((r.random((WIDE_ROWS, 4)) * 255).astype(np.float32)).to(dev)
    x = torch.from_numpy((r.normal(size=(WIDE_ROWS, sd)) * 1e3).astype(np.float32)).to(dev)
    x[:, ::7] = -0.0
    for e in WIDE_ENTRIES:
        idx = torch.from_numpy(r.integers(0, e, WIDE_ROWS)).to(dev)
        skew = torch.where(torch.rand(WIDE_ROWS, device=dev) < 0.9, e - 1, idx)
        for name, ix in (("random", idx), ("skewed", skew)):
            hold_bits(torch, err, "etc1s_segment_sum", k.segment_sum(ix, e, x),
                      k.segment_sum_plain(ix, e, x))
        cb = feats[torch.from_numpy(r.choice(WIDE_ROWS, e, replace=False)).to(dev)] + 0.25
        cb[-1] = cb[0]  # a duplicate past the first window: ties go to the first
        hold_bits(torch, err, "etc1s_kmeans_iter", k.kmeans_iter(feats, cb),
                  k.kmeans_iter_plain(feats, cb))
        base = torch.from_numpy(r.integers(0, 256, (e, 3)).astype(np.int32)).to(dev)
        inten = torch.from_numpy(r.integers(0, 8, e).astype(np.int32)).to(dev)
        table = k.endpoint_table(base, inten)
        hold(err, "etc1s_assign_endpoints", k.assign_endpoints(blocks, table),
             k.assign_endpoints_plain(blocks, table))
        nby, nbx = WIDE_K7_FRAME
        for lam, dup, prev, flat in ((60.0, False, True, "mixed"), (0.0, True, True, "mixed"),
                                     (60.0, False, False, "none")):
            args = to_device(sweep_frame(torch, r, nby, nbx, e, dup, prev, flat), dev)
            hold(err, "etc1s_rate_sweep", k.rate_sweep_frame(*args, 0, lam, 1.5, nbx),
                 k.rate_sweep_frame_plain(*args, 0, lam, 1.5, nbx))
    for f, n, d in U5_WIDE_SHAPES:
        res, p = u5_chain(r, f, n, d)
        got = mc.parallelogram_decode(torch.from_numpy(res).to(dev), torch.from_numpy(p).to(dev))
        same_bits(torch, err, "parallelogram_decode", got,
                  mc.parallelogram_decode_plain(torch.from_numpy(res), torch.from_numpy(p)))
    parity_s = time.perf_counter() - t0

    # ---- B's segment at WIDE_PALETTE/WIDE_PALETTE: launches, bytes, times
    frames = textures[:ETC1S_LAYERS]
    kw = {"num_endpoints": WIDE_PALETTE, "num_selectors": WIDE_PALETTE}
    k.reset_launches()
    blob = encode_ktx2_etc1s(frames, device=DEVICE, **kw)
    torch.cuda.synchronize()
    launches = dict(k.LAUNCHES)
    for name in ETC1S_BUILD_KERNELS + ("etc1s_rate_sweep",):
        check(launches[name] >= 1, f"the {WIDE_PALETTE}-entry segment never launched {name}")
    check(encode_ktx2_etc1s(frames, device=DEVICE, **kw) == blob,
          f"the {WIDE_PALETTE}-entry segment encode is not deterministic")
    pal = build_palettes(frames, device=DEVICE, **kw)
    check(len(pal.color5) == WIDE_PALETTE and len(pal.selectors) == WIDE_PALETTE,
          "the wide palettes are not WIDE_PALETTE entries")
    ms["etc1s_wide_build_palettes"] = wall_ms(
        torch, lambda: build_palettes(frames, device=DEVICE, **kw), ETC1S_REPS)
    ms["etc1s_wide_segment_encode"] = wall_ms(
        torch, lambda: encode_ktx2_etc1s(frames, device=DEVICE, **kw), ETC1S_REPS)
    psnr = psnr_db(transcode_ktx2_etc1s(read_ktx2(blob))[..., :3], frames)
    small = textures[:1, :WIDE_CPU_SIDE, :WIDE_CPU_SIDE]
    t = time.perf_counter()
    cpu_blob = encode_ktx2_etc1s(small, device="cpu", **kw)
    cpu_s = time.perf_counter() - t
    check(encode_ktx2_etc1s(small, device=DEVICE, **kw) == cpu_blob,
          f"the card's bytes differ from the CPU port's at {WIDE_PALETTE} entries")

    # ---- the wide calls on the main path's shapes: per call, twin, bound
    bd = torch.from_numpy(np.ascontiguousarray(
        frames.reshape(ETC1S_LAYERS, H // 4, 4, W // 4, 4, 3).transpose(0, 1, 3, 2, 4, 5)
        .reshape(-1, 16, 3))).to(dev)
    ne = bd.shape[0]
    feats_b = bd.float().mean(1)
    feats_b = torch.cat([feats_b, bd.float().std(1).mean(1, keepdim=True)], 1).contiguous()
    xs = torch.from_numpy((r.normal(size=(sn, sd)) * 1e3).astype(np.float32)).to(dev)
    nr = (H // 4) * (W // 4)
    for e in WIDE_TIMED:
        idx = torch.from_numpy(r.integers(0, e, sn)).to(dev)
        key = f"etc1s_segment_sum_k{e}"
        ms[key] = median_cuda_ms(lambda: k.segment_sum(idx, e, xs), REPS)
        ms[key + "_plain"] = once_ms(torch, lambda: k.segment_sum_plain(idx, e, xs))
        wide.setdefault("etc1s_segment_sum", {})[f"k{e}"] = {
            "shape": [sn, e, sd], "ms": ms[key], "plain_ms": ms[key + "_plain"],
            **dict(zip(("bound_ms", "bound_by"), bound(
                sn * (sd + 1) * 4 + e * sd * 4, OPS["etc1s_segment_sum"] * sn * sd,
                F32_FLOP_PER_S)))}
    e = WIDE_TIMED[0]
    cb = feats_b[torch.from_numpy(r.choice(ne, e, replace=False)).to(dev)] + 0.25
    key = f"etc1s_kmeans_iter_k{e}"
    ms[key] = median_cuda_ms(lambda: k.kmeans_iter(feats_b, cb), REPS)
    ms[key + "_plain"] = once_ms(torch, lambda: k.kmeans_iter_plain(feats_b, cb))
    wide["etc1s_kmeans_iter"] = {f"k{e}": {
        "shape": [ne, e], "ms": ms[key], "plain_ms": ms[key + "_plain"],
        **dict(zip(("bound_ms", "bound_by"), bound(
            ne * 16 + e * 16 + ne * 4 + e * 20, OPS["etc1s_kmeans_iter"] * ne * e,
            F32_FLOP_PER_S)))}}
    base = torch.from_numpy(r.integers(0, 256, (e, 3)).astype(np.int32)).to(dev)
    table = k.endpoint_table(base, torch.from_numpy(r.integers(0, 8, e).astype(np.int32)).to(dev))
    key = f"etc1s_assign_endpoints_e{e}"
    ms[key] = median_cuda_ms(lambda: k.assign_endpoints(bd, table), REPS)
    wide["etc1s_assign_endpoints"] = {f"e{e}": {
        "shape": [ne, e], "ms": ms[key],
        **dict(zip(("bound_ms", "bound_by"), bound(
            ne * 48 + e * 80 + ne * 4, OPS["etc1s_assign_endpoints"] * ne * e,
            INT_OPS_PER_S)))}}
    args = to_device(sweep_frame(torch, r, H // 4, W // 4, e, False, True, "mixed"), dev)
    key = f"etc1s_rate_sweep_e{e}"
    ms[key] = median_cuda_ms(lambda: k.rate_sweep_frame(*args, 0, 60.0, 1.5, W // 4), REPS)
    ms[key + "_plain"] = once_ms(
        torch, lambda: k.rate_sweep_frame_plain(*args, 0, 60.0, 1.5, W // 4))
    wide["etc1s_rate_sweep"] = {f"e{e}": {
        "shape": [nr, e], "ms": ms[key], "plain_ms": ms[key + "_plain"],
        **dict(zip(("bound_ms", "bound_by"), bound(
            nr * 48 + e * (12 + 16 + 4) + 8 * 64 + nr * 4 * 4 + nr * 2 * 4,
            OPS["etc1s_rate_sweep"] * nr * e, INT_OPS_PER_S)))}}
    f, n, d = U5_WIDE_SHAPES[0]
    res, p = u5_chain(r, f, n, d)
    res_d, p_d = torch.from_numpy(res).to(dev), torch.from_numpy(p).to(dev)
    key = f"parallelogram_decode_n{n}"
    ms[key] = median_cuda_ms(lambda: mc.parallelogram_decode(res_d, p_d), REPS)
    ms[key + "_plain"] = once_ms(
        torch, lambda: mc.parallelogram_decode_plain(torch.from_numpy(res), torch.from_numpy(p)))
    wide["parallelogram_decode"] = {f"n{n}": {
        "shape": [f, n, d], "ms": ms[key], "plain_ms": ms[key + "_plain"],
        **dict(zip(("bound_ms", "bound_by"), bound(
            f * n * d * 8 + f * n * 12, OPS["parallelogram_decode"] * f * n * d, INT_OPS_PER_S))),
        "chain_bound_ms": n * U5_STEP_CYCLES / SM_CLOCK_HZ * 1e3}}
    attrs = _build.kernel_attrs()
    wide_attrs = {fn: attrs[fn] for fn in ("rate_sweep_frame_kernel_wide", "sweep_table_kernel",
                                           "parallelogram_decode_kernel_global")}
    emit({"phase": "wide_palette_path", "entries": WIDE_ENTRIES, "rows": WIDE_ROWS,
          "kernel_attrs": wide_attrs,
          "k7_frame": WIDE_K7_FRAME, "u5_shapes": U5_WIDE_SHAPES, "parity_s": parity_s,
          "segment": {"layers": ETC1S_LAYERS, "size": [H, W], "palette": WIDE_PALETTE,
                      "launches": launches, "ktx2_bytes": len(blob),
                      "transcoded_psnr_db": psnr, "cpu_side": WIDE_CPU_SIDE,
                      "cpu_bytes_equal": True, "cpu_s": cpu_s},
          "max_abs_err": err, "ms": ms, "wide": wide, "seconds": time.perf_counter() - t0})
    return err, ms, wide, launches


def python_draco_path(torch, textures) -> None:
    """The copied Python Draco decoder on the card's host: a V2 project (the
    CLI's draco + etc on PYDRC_FRAMES frames of DRC_GRID grids) whose `.drc`
    frames are rewritten with the standard edge coder, which the native
    decoder refuses; played sync on the card, every `ok` tick held to the
    decoder's output. One 26,145-vertex frame decoded on each path: the
    native whole-frame decoder (the valence coder), the staged Python
    decoder with its native helpers (the standard coder), and the Python
    decoder alone (`UVT_DISABLE_NATIVE_DRACO=1`)."""
    import os
    import shutil

    from uvol_tpu_torch import native
    from uvol_tpu_torch.codecs.draco import constants as K
    from uvol_tpu_torch.codecs.draco.decoder import decode_drc
    from uvol_tpu_torch.codecs.draco.encoder import AttributeToEncode, encode_drc
    from uvol_tpu_torch.codecs.draco.grid import grid_attributes
    from uvol_tpu_torch.io.meshio import load_mesh

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "python_draco_path"
    shutil.rmtree(root, ignore_errors=True)
    inputs = cli_inputs(root / "inputs", PYDRC_FRAMES, DRC_GRID,
                        textures[:PYDRC_FRAMES, :PYDRC_SIDE, :PYDRC_SIDE])
    cfg = cli_config(root / "E.json", inputs, root / "E", TEXTURE_CODEC="etc", ENCODE_WORKERS=1)
    cli_encode(torch, cfg)
    c = json.loads(open(cfg).read())
    qp, qt, qn = c["Q_POSITION_ATTR"], c["Q_TEXTURE_ATTR"], c["Q_NORMAL_ATTR"]
    for i in range(PYDRC_FRAMES):
        m = load_mesh(inputs[0].replace("[#####]", f"{i:05d}"))
        atts = [AttributeToEncode(K.ATT_POSITION, m.positions, m.faces.reshape(-1), qp),
                AttributeToEncode(K.ATT_TEX_COORD, m.uvs, np.asarray(m.uv_faces).reshape(-1), qt),
                AttributeToEncode(K.ATT_NORMAL, m.normals,
                                  np.asarray(m.normal_faces).reshape(-1), qn)]
        blob = encode_drc(np.asarray(m.faces), atts, traversal_encoding="standard")
        check(native.drc_decode_native(blob) is None,
              "a standard-coder frame took the native whole-frame decoder")
        (root / "E" / "geometry_draco" / f"{i:05d}.drc").write_bytes(blob)
    manifest = str(root / "E" / "smoke.uvol.json")
    ticks, v2, decode_ms, play_launches = play(torch, manifest, False)
    ok = hold_playback(ticks, v2, PYDRC_FRAMES, c["KTX2_BATCH_SIZE"])
    check(play_launches.get("etc1_decode", 0) >= 1, "the Python-Draco project never launched K2")

    faces, atts = grid_attributes(*DRC_GRID, 0, DRC_BITS)
    val = encode_drc(faces, atts)
    std = encode_drc(faces, atts, traversal_encoding="standard")
    check(native.drc_decode_native(val) is not None and native.drc_decode_native(std) is None,
          "the valence frame left, or the standard frame took, the native decoder")
    ms = {"native_valence": wall_ms(torch, lambda: decode_drc(val)),
          "python_staged_standard": wall_ms(torch, lambda: decode_drc(std))}
    pure = []
    os.environ["UVT_DISABLE_NATIVE_DRACO"] = "1"
    try:
        ms["python_alone_standard"] = once_ms(torch, lambda: pure.append(decode_drc(std)))
    finally:
        os.environ.pop("UVT_DISABLE_NATIVE_DRACO")
    pure, want = pure[0], decode_drc(std)
    check(np.array_equal(pure.faces, want.faces) and all(
        np.array_equal(a.values, b.values) for a, b in zip(pure.attributes, want.attributes)),
        "the Python decoder alone differs from the staged one")
    emit({"phase": "python_draco_path", "frames": PYDRC_FRAMES, "grid": DRC_GRID,
          "ok_ticks": ok, "ticks": len(ticks), "decode_ms_playback": decode_ms,
          "playback_launches": play_launches, "frame_decode_ms": ms,
          "vertices": int(want.num_points), "seconds": time.perf_counter() - t0})
    shutil.rmtree(root, ignore_errors=True)


def write_png(path, img: np.ndarray) -> None:
    """[H, W, 3] uint8 -> an RGB PNG with zlib alone (the card machine has
    no Pillow); the rows take the None, Sub and Up filters in turn."""
    h, w, _ = img.shape
    rows = img.reshape(h, w * 3).astype(np.int16)
    left = np.zeros_like(rows)
    left[:, 3:] = rows[:, :-3]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    kind = (np.arange(h) % 3)[:, None]
    filt = np.where(kind == 1, rows - left, np.where(kind == 2, rows - up, rows)) & 0xFF
    raw = np.concatenate([kind, filt], 1).astype(np.uint8).tobytes()

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_obj(path, pos, uv, nrm, faces) -> None:
    """One OBJ frame: v, vt and vn per vertex, faces indexing all three alike."""
    lines = [f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in pos.tolist()]
    lines += [f"vt {a:.6f} {b:.6f}" for a, b in uv.tolist()]
    lines += [f"vn {a:.6f} {b:.6f} {c:.6f}" for a, b, c in nrm.tolist()]
    lines += ["f {0}/{0}/{0} {1}/{1}/{1} {2}/{2}/{2}".format(*f)
              for f in (faces + 1).tolist()]
    path.write_text("\n".join(lines) + "\n")


def cli_inputs(root, frames: int, grid: tuple, textures: np.ndarray) -> tuple:
    """OBJ frames of `grid` (`grid_mesh` seeds 0..frames-1) and one PNG per
    texture layer under root; returns their path templates."""
    from uvol_tpu_torch.codecs.draco.grid import grid_mesh

    (root / "OBJ").mkdir(parents=True)
    (root / "images").mkdir()
    for i in range(frames):
        write_obj(root / "OBJ" / f"{i:05d}.obj", *grid_mesh(*grid, seed=i))
    for i, img in enumerate(textures):
        write_png(root / "images" / f"{i:05d}.png", img)
    return str(root / "OBJ" / "[#####].obj"), str(root / "images" / "[#####].png")


def cli_config(path, inputs: tuple, out_dir, **over) -> str:
    """A project config: the CLI's `TEMPLATE` with `over` on top."""
    from uvol_tpu_torch.encoder_cli import TEMPLATE

    cfg = {**TEMPLATE, "name": "smoke", "OBJFilesPath": inputs[0], "ImagesPath": inputs[1],
           "OutputDirectory": str(out_dir), "ENCODE_WORKERS": CLI_WORKERS, **over}
    path.write_text(json.dumps(cfg))
    return str(path)


def all_launches() -> dict:
    from uvol_tpu_torch.codecs.basis import etc1s_cuda, etc_cuda, uastc_cuda
    from uvol_tpu_torch.models import drc_device
    from uvol_tpu_torch.ops import pallas_kernels

    return {**etc_cuda.LAUNCHES, **pallas_kernels.LAUNCHES, **etc1s_cuda.LAUNCHES,
            **drc_device.LAUNCHES, **uastc_cuda.LAUNCHES}


def reset_all_launches() -> None:
    from uvol_tpu_torch.codecs.basis import etc1s_cuda, etc_cuda, uastc_cuda
    from uvol_tpu_torch.models import drc_device
    from uvol_tpu_torch.ops import pallas_kernels

    for mod in (etc_cuda, pallas_kernels, etc1s_cuda, drc_device, uastc_cuda):
        mod.reset_launches()


def stats_seconds(stats) -> dict:
    """Total seconds of every timer in the registry."""
    return {k: v["mean"] * v["count"] for k, v in stats.snapshot()["timings"].items()}


def tree(root) -> dict:
    """Every file under root: relative path -> (bytes, mtime in ns)."""
    return {str(p.relative_to(root)): (p.read_bytes(), p.stat().st_mtime_ns)
            for p in sorted(root.rglob("*")) if p.is_file()}


def cli_encode(torch, cfg_path: str) -> dict:
    """One in-process run of the port's CLI on `cfg_path`: its wall time,
    stage times (`STATS`) and every kernel's launches."""
    from uvol_tpu_torch.encoder_cli import main as cli_main
    from uvol_tpu_torch.utils.stats import STATS

    torch.cuda.synchronize()
    reset_all_launches()
    STATS.reset()
    printed = io.StringIO()  # the CLI's progress lines stay off the smoke's stdout
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli_main([cfg_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(rc == 0, f"the encoder CLI returned {rc} on {cfg_path}: {printed.getvalue()[-500:]}")
    return {"wall_s": wall, "stage_s": stats_seconds(STATS),
            "launches": {k: v for k, v in all_launches().items() if v}}


def play(torch, manifest: str, async_prefetch: bool) -> tuple:
    """The port's facade `Player` on the card, on a `VirtualClock` at
    `CLI_TICK` until the track ends; with `async_prefetch` the pools are
    waited for after each tick, so the ticks are the sync run's. Returns
    (every tick's FrameResult, the V2 player, decode seconds, launches)."""
    from uvol_tpu_torch.interfaces import PlayMode
    from uvol_tpu_torch.player import PlaybackClock, Player, VirtualClock
    from uvol_tpu_torch.utils.stats import STATS

    torch.cuda.synchronize()
    reset_all_launches()
    STATS.reset()
    vc = VirtualClock()
    ended = []
    p = Player(play_mode=PlayMode.single, paths=[manifest], on_track_end=lambda: ended.append(1),
               device=DEVICE, v2_player_kwargs={"clock": PlaybackClock(now=vc),
                                                "async_prefetch": async_prefetch})
    p.set_track_path()

    def settle():
        if async_prefetch:
            p.v2_instance._geo_pool.wait_idle(timeout=600)
            p.v2_instance._tex_pool.wait_idle(timeout=600)

    settle()
    ticks = []
    while not ended:
        check(len(ticks) < 100000, "the track never ended")
        vc.advance(CLI_TICK)
        ticks.append(p.update())
        settle()
    p.dispose()
    torch.cuda.synchronize()
    timings = STATS.snapshot()["timings"]
    decode_ms = {k.split(".")[1]: {"count": v["count"], "mean_ms": v["mean"] * 1e3,
                                   "p50_ms": v["p50"] * 1e3, "max_ms": v["max"] * 1e3}
                 for k, v in timings.items() if k.startswith("v2.")}
    return ticks, p.v2_instance, decode_ms, {k: v for k, v in all_launches().items() if v}


def hold_playback(ticks, v2, frames: int, seq: int) -> int:
    """Every `ok` tick's geometry equals the port's decoder's output for that
    frame's file, its texture the decode of that segment's file, and its
    layer is `frame % seq`; every frame of the track but the first showed.
    Returns the `ok` ticks."""
    from uvol_tpu_torch.codecs.basis.transcoder import transcode_ktx2_etc1s
    from uvol_tpu_torch.codecs.basis.uastc import transcode_uastc
    from uvol_tpu_torch.codecs.draco.decoder import decode_drc
    from uvol_tpu_torch.containers.ktx2 import KHR_DF_MODEL_UASTC, read_ktx2
    from uvol_tpu_torch.models.sequence import GeometrySequenceCodec, TextureSequenceCodec

    geo = GeometrySequenceCodec(device=DEVICE)
    tex = TextureSequenceCodec(device=DEVICE)
    segments, shown = {}, set()
    ok = [r for r in ticks if r.status == "ok"]
    for r in ok:
        data = open(v2.geometry_url(r.geometry_frame), "rb").read()
        if data[:4] == b"UVTG":
            want = geo.decode([data])
            check(np.array_equal(r.geometry.positions, want.positions)
                  and np.array_equal(r.geometry.uvs, want.uvs)
                  and all(np.array_equal(a, b) for a, b in zip(r.geometry.faces, want.faces)),
                  f"frame {r.geometry_frame}: geometry differs from its decoder's")
        else:
            want = decode_drc(data)
            check(np.array_equal(r.geometry.faces, want.faces)
                  and all(np.array_equal(a.values, b.values)
                          and np.array_equal(a.corner_to_value, b.corner_to_value)
                          for a, b in zip(r.geometry.attributes, want.attributes, strict=True)),
                  f"frame {r.geometry_frame}: geometry differs from its decoder's")
        s = r.texture_segment
        if s not in segments:
            ktx = read_ktx2(open(v2.texture_url(s), "rb").read())
            segments[s] = (transcode_ktx2_etc1s(ktx, target="etc1") if ktx.basis_lz is not None
                           else transcode_uastc(ktx, "etc2-eac", device=DEVICE)
                           if ktx.dfd_color_model() == KHR_DF_MODEL_UASTC
                           else tex.decode_segment(ktx))
        check(r.texture_layer == r.geometry_frame % seq, "the layer is not frame % sequenceSize")
        check(np.array_equal(np.asarray(r.texture)[r.texture_layer],
                             segments[s][r.geometry_frame % seq]),
              f"frame {r.geometry_frame}: texture layer differs from its segment's decode")
        shown.add(r.geometry_frame)
    # the first tick comes 1/60 s after the start, where frame round(0.5) may be 1
    check(set(range(1, frames)) <= shown, f"frames {set(range(1, frames)) - shown} never showed")
    return len(ok)


def same_ticks(a, b) -> bool:
    """Two runs' ticks: the same statuses, frames, segments and layers, and
    on `ok` ticks the same geometry and texture arrays."""
    key = [(r.status, r.geometry_frame, r.texture_segment, r.texture_layer) for r in a]
    if key != [(r.status, r.geometry_frame, r.texture_segment, r.texture_layer) for r in b]:
        return False
    for x, y in zip(a, b):
        if x.status != "ok":
            continue
        gx, gy = x.geometry, y.geometry
        arrays = (([gx.positions, gx.uvs], [gy.positions, gy.uvs]) if hasattr(gx, "positions")
                  else ([gx.faces] + [t.values for t in gx.attributes],
                        [gy.faces] + [t.values for t in gy.attributes]))
        if not all(np.array_equal(p, q) for p, q in zip(*arrays)):
            return False
        if x.texture.format != y.texture.format or not np.array_equal(
                np.asarray(x.texture), np.asarray(y.texture)):
            return False
    return True


def cli_player_path(torch, textures) -> tuple:
    """The port's own entry points at liam scale: the encoder CLI
    (`uvol_tpu_torch.encoder_cli.main`, in process) and the facade
    `Player`, on the card. Project A, the CLI's defaults (`TEMPLATE`:
    draco at 11/10/8, `etc1s` at 1024/1024, 5 layers a segment, 8 Draco
    workers spawned while CUDA is live), and project B, the same inputs
    through `uvtg` and `etc`: each encoded, encoded again (nothing may be
    written), then played at 1/60 s ticks, sync and with
    `async_prefetch`; every `ok` tick held to the decoders' own output.
    Project C, small, encoded on the card and on the CPU: the same bytes
    in every file. Returns each kernel's launches over the CLI and player
    runs."""
    import os
    import shutil

    root = Path(__file__).resolve().parent / "build" / "cli_player_path"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    inputs = cli_inputs(root / "inputs", CLI_FRAMES, DRC_GRID, textures[:CLI_FRAMES])
    inputs_s = time.perf_counter() - t0
    projects = {"A": {}, "B": {"GEOMETRY_CODEC": "uvtg", "TEXTURE_CODEC": "etc"}}
    want_encode = {"A": ETC1S_BUILD_KERNELS + ("etc1s_rate_sweep",),
                   "B": ("geometry_minmax", "quantize_delta_zigzag", "etc1_encode")}
    totals, report = {}, {}
    from uvol_tpu_torch.encoder_cli import TEMPLATE

    seq = TEMPLATE["KTX2_BATCH_SIZE"]
    for name, over in projects.items():
        out = root / name
        cfg = cli_config(root / f"{name}.json", inputs, out, **over)
        first = cli_encode(torch, cfg)
        for k in want_encode[name]:
            check(first["launches"].get(k, 0) >= 1, f"project {name}'s encode never launched {k}")
        before = tree(out)
        again = cli_encode(torch, cfg)
        check(tree(out) == before, f"the second CLI run of project {name} wrote a file")
        manifest = str(out / "smoke.uvol.json")
        m = json.loads(open(manifest).read())
        geo_t = next(iter(m["geometry"]["targets"].values()))
        check(geo_t["frameCount"] == CLI_FRAMES, "manifest frame count")
        for t in m["texture"]["targets"].values():
            check(t["sequenceCount"] == -(-CLI_FRAMES // seq) and t["resolution"] == [W, H],
                  "manifest texture target")
        sync, v2, decode_ms, play_launches = play(torch, manifest, False)
        ok = hold_playback(sync, v2, CLI_FRAMES, seq)
        asyn, v2a, decode_ms_async, _ = play(torch, manifest, True)
        check(hold_playback(asyn, v2a, CLI_FRAMES, seq) == ok,
              "the async run showed other frames")
        check(same_ticks(asyn, sync), f"project {name}: the async ticks differ from the sync ones")
        if name == "B":
            check(play_launches.get("etc1_decode", 0) >= 1, "project B's playback never launched K2")
        for src in (first["launches"], play_launches):
            for k, v in src.items():
                totals[k] = totals.get(k, 0) + v
        files = sum(1 for _ in out.rglob("*") if _.is_file())
        report[name] = {
            "config": {k: v for k, v in json.loads(open(cfg).read()).items()
                       if k in ("GEOMETRY_CODEC", "TEXTURE_CODEC", "ETC1S_ENDPOINTS",
                                "ETC1S_SELECTORS", "KTX2_BATCH_SIZE", "ENCODE_WORKERS",
                                "Q_POSITION_ATTR", "Q_TEXTURE_ATTR", "Q_NORMAL_ATTR")},
            "files": files, "bytes": sum(len(b) for b, _ in tree(out).values()),
            "encode_s": first["wall_s"], "encode_fps": CLI_FRAMES / first["wall_s"],
            "stage_s": first["stage_s"], "encode_launches": first["launches"],
            "second_run_s": again["wall_s"], "second_run_launches": again["launches"],
            "ticks": len(sync), "ok_ticks": ok,
            "statuses": {s: [r.status for r in sync].count(s)
                         for s in sorted({r.status for r in sync})},
            "decode_ms": decode_ms, "decode_ms_async": decode_ms_async,
            "playback_launches": play_launches,
        }
        emit({"phase": "cli_player_project", "project": name, **report[name]})

    # project C: the card's files = the CPU port's files, every one
    small = np.stack([np.roll(textures[i, :CLI_C_SIDE, :CLI_C_SIDE], 7 * i, axis=0)
                      for i in range(CLI_C_FRAMES)])
    inputs_c = cli_inputs(root / "inputs_c", CLI_C_FRAMES, CLI_C_GRID, small)
    runs = {}
    for where in ("cuda", "cpu"):
        cfg = cli_config(root / f"C_{where}.json", inputs_c, root / f"C_{where}",
                         GEOMETRY_CODEC="uvtg", TEXTURE_CODEC=CLI_C_CODECS)
        saved = os.environ.pop("UVT_PLATFORM", None)
        if where == "cpu":
            os.environ["UVT_PLATFORM"] = "cpu"
        try:
            runs[where] = cli_encode(torch, cfg)
        finally:
            os.environ.pop("UVT_PLATFORM", None)
            if saved is not None:
                os.environ["UVT_PLATFORM"] = saved
    card = {k: b for k, (b, _) in tree(root / "C_cuda").items()}
    cpu = {k: b for k, (b, _) in tree(root / "C_cpu").items()}
    check(sorted(card) == sorted(cpu), "project C: the card and the CPU wrote other files")
    differ = [k for k in card if card[k] != cpu[k]]
    check(not differ, f"project C: card and CPU bytes differ in {differ[:4]}")
    check(runs["cuda"]["launches"].get("quantize_delta_zigzag", 0) >= 1
          and runs["cpu"]["launches"] == {}, "project C: the card run launched no kernel, "
          "or the CPU run launched one")
    emit({"phase": "cli_player_path", "inputs_s": inputs_s,
          "projects": {k: {"encode_s": v["encode_s"], "encode_fps": v["encode_fps"],
                           "ok_ticks": v["ok_ticks"]} for k, v in report.items()},
          "project_c": {"files": len(card), "bytes_equal": True,
                        "card_s": runs["cuda"]["wall_s"], "cpu_s": runs["cpu"]["wall_s"],
                        "card_launches": runs["cuda"]["launches"]},
          "launches": totals, "total_s": time.perf_counter() - t0})
    shutil.rmtree(root, ignore_errors=True)
    return totals


def uastc_blocks(textures) -> np.ndarray:
    """The bench texture's layers as opaque UASTC input blocks, [B, 16, 4]."""
    from uvol_tpu_torch.codecs.basis.uastc import image_to_blocks_rgba

    opaque = np.full(textures.shape[1:3] + (1,), 255, np.uint8)
    return np.concatenate([image_to_blocks_rgba(np.concatenate([t, opaque], -1))
                           for t in textures]).reshape(-1, 16, 4)


def uastc_classes(px: np.ndarray) -> dict:
    """`UASTC_CLASSES` at the main path's block count: the bench's gradient
    blocks `px` and, from a seed, random, flat and two-colour blocks (each
    pixel one of two random colours), [B, 16, 4] uint8, opaque."""
    r = np.random.default_rng(21)
    nb = len(px)
    two = r.integers(0, 256, (2, nb, 1, 4), dtype=np.uint8)
    out = {"bench_gradient": px,
           "random": r.integers(0, 256, (nb, 16, 4), dtype=np.uint8),
           "flat": np.repeat(r.integers(0, 256, (nb, 1, 4), dtype=np.uint8), 16, 1),
           "two_colour": np.where(r.random((nb, 16, 1)) < 0.5, two[0], two[1])}
    for v in out.values():
        v[..., 3] = 255
    check(tuple(out) == UASTC_CLASSES, "the U1 block classes")
    return out


def weight_index_exhaustive(torch, dev) -> dict:
    """U1's nearest weight entry in closed form (`uastc_cuda.weight_index`,
    the kernel's own device function) against the twin's scan
    (`weight_index_plain`) on the card, for every float32 in [0, 64] (the
    bit patterns 0 to that of 64.0) and each weight table; fails on any
    difference."""
    from uvol_tpu_torch.codecs.basis import uastc_cuda
    from uvol_tpu_torch.codecs.basis.uastc import WEIGHT_TABLES

    top = int(np.float32(64.0).view(np.int32))
    t = time.perf_counter()
    bad = {}
    for levels in WEIGHT_TABLES:
        bad[levels] = 0
        for lo in range(0, top + 1, UASTC_WEIGHT_CHUNK):
            w = torch.arange(lo, min(lo + UASTC_WEIGHT_CHUNK, top + 1), dtype=torch.int32,
                             device=dev).view(torch.float32)
            bad[levels] += int((uastc_cuda.weight_index(w, levels)
                                != uastc_cuda.weight_index_plain(w, levels)).sum())
    torch.cuda.synchronize()
    check(not any(bad.values()), f"the closed-form weight index differs from the scan: {bad}")
    return {"floats": top + 1, "tables": list(WEIGHT_TABLES), "mismatches": bad,
            "s": time.perf_counter() - t}


def uastc_device_fit_path(torch, dev, textures, median_cuda_ms) -> tuple:
    """U1 at the main path's size: `encode_uastc_blocks(device_fit="auto")`
    on the bench's F layers of 1024^2 (2,097,152 blocks, the default RGB
    pair [0, 5]) must launch the kernel once; the kernel's winners and
    fields bit for bit against its plain twin on the card for [0, 5], for
    [10, 12] on an alpha-ramp copy, and for all eleven eligible modes;
    `encode_uastc_blocks` and the legacy `encode_uastc_ktx2` with the
    device fit on the card write the CPU port's bytes; the call (CUDA
    events), the kernel alone (profiler) and the twin, per mode list.
    Returns (launches, max_abs_err, ms)."""
    from uvol_tpu_torch import _build
    from uvol_tpu_torch.codecs.basis import uastc, uastc_cuda

    px = uastc_blocks(textures)
    nblocks = len(px)
    t = time.perf_counter()
    torch.cuda.synchronize()
    reset_all_launches()
    main_bytes = uastc.encode_uastc_blocks(px.reshape(-1, 4, 4, 4), device=DEVICE)
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_launches().items() if v}
    main_s = time.perf_counter() - t
    check(launches == {"uastc_device_fit": 1},
          f"encode_uastc_blocks at {nblocks} blocks launched {launches}, not U1 once")
    check(main_bytes.shape == (nblocks, 16), "encode_uastc_blocks output shape")

    ramp = px.copy()
    ramp[:, :, 3] = np.linspace(0, 255, 16).astype(np.uint8)[None] // (1 + np.arange(nblocks) % 4)[:, None]
    inputs = {"rgb": torch.from_numpy(px).to(dev), "rgba": torch.from_numpy(ramp).to(dev)}
    inputs["all"] = inputs["rgb"]
    err, ms, winners = {"uastc_device_fit": 0}, {}, {}
    for name, modes in UASTC_MODE_SETS.items():
        x = inputs[name]
        got = uastc_cuda.device_fit(x, modes)
        hold_bits(torch, err, "uastc_device_fit", got, uastc_cuda.device_fit_select_plain(x, modes))
        winners[name] = np.bincount(got[0].cpu().numpy(), minlength=len(modes)).tolist()
        key = "uastc_device_fit" if name == "rgb" else f"uastc_device_fit_{name}"
        ms[key] = median_cuda_ms(lambda: uastc_cuda.device_fit(x, modes), REPS)
        ms[key + "_plain"] = median_cuda_ms(
            lambda: uastc_cuda.device_fit_select_plain(x, modes), REPS)
        ms[key + "_kernel"], _ = kernel_only_ms(
            torch, lambda: uastc_cuda.device_fit(x, modes), WRAPPER_KERNELS["uastc_device_fit"])
    # U1 at the main path's blocks and modes on each block class, and its
    # closed-form weight index against the scan on every float32 in [0, 64]
    classes = uastc_classes(px)
    per_class = {}
    for name, blocks in classes.items():
        x = torch.from_numpy(blocks).to(dev)
        modes = UASTC_MODE_SETS["rgb"]
        got = uastc_cuda.device_fit(x, modes)
        hold_bits(torch, err, "uastc_device_fit", got, uastc_cuda.device_fit_select_plain(x, modes))
        per_class[name] = {
            "ms": median_cuda_ms(lambda: uastc_cuda.device_fit(x, modes), REPS),
            "kernel_ms": kernel_only_ms(torch, lambda: uastc_cuda.device_fit(x, modes),
                                        WRAPPER_KERNELS["uastc_device_fit"])[0],
            "winners": np.bincount(got[0].cpu().numpy(), minlength=len(modes)).tolist()}
        del x, got
    weights = weight_index_exhaustive(torch, dev)
    # the entry points on the card against the CPU port: 2 layers of 256^2
    small = textures[:UASTC_CPU_LAYERS, :UASTC_CPU_SIDE, :UASTC_CPU_SIDE]
    small_px = uastc_blocks(small).reshape(-1, 4, 4, 4)
    for modes in (None, list(UASTC_MODE_SETS["all"])):
        card = uastc.encode_uastc_blocks(small_px, modes, device_fit=True, device=DEVICE)
        cpu = uastc.encode_uastc_blocks(small_px, modes, device_fit=True, device="cpu")
        check(np.array_equal(card, cpu), f"encode_uastc_blocks({modes}) card != CPU")
    for quality in (0, 2):
        card = uastc.encode_uastc_ktx2(small, wire="legacy", device_fit=True, device=DEVICE,
                                       quality=quality)
        cpu = uastc.encode_uastc_ktx2(small, wire="legacy", device_fit=True, device="cpu",
                                      quality=quality)
        check(card == cpu, f"legacy encode_uastc_ktx2 at quality {quality}: card != CPU")
    attrs = _build.kernel_attrs()
    for fn in ("uastc_device_fit_kernel", "weight_index_kernel"):
        check(attrs[fn]["stack_bytes"] == 0, f"{fn} uses stack memory")
    emit({"phase": "uastc_device_fit", "blocks": nblocks, "main_path_s": main_s,
          "launches": launches, "winners": winners, "max_abs_err": err, "ms": ms,
          "classes": per_class, "weight_index_exhaustive": weights,
          "cpu_compare": {"layers": UASTC_CPU_LAYERS, "side": UASTC_CPU_SIDE,
                          "bytes_equal": True},
          "kernel_attrs": {fn: attrs[fn] for fn in ("uastc_device_fit_kernel",
                                                    "weight_index_kernel")}})
    return launches, err, ms


def uastc_project_path(torch, textures) -> dict:
    """Project D: the CLI's `TEMPLATE` with `TEXTURE_CODEC` "uastc" on
    UASTC_FRAMES OBJ frames and 1024^2 layers, encoded, encoded again
    (nothing may be written), played at 1/60 s ticks sync and with
    `async_prefetch` (every `ok` tick held to the decoders' output, K1
    launched), and its segments transcoded to etc2-eac and etc1 on the card
    and on the CPU (the same words). Returns each kernel's launches over
    the CLI and player runs."""
    import shutil

    from uvol_tpu_torch.codecs.basis.uastc import transcode_uastc
    from uvol_tpu_torch.containers.ktx2 import read_ktx2
    from uvol_tpu_torch.encoder_cli import TEMPLATE

    root = Path(__file__).resolve().parent / "build" / "uastc_path"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    inputs = cli_inputs(root / "inputs", UASTC_FRAMES, DRC_GRID, textures[:UASTC_FRAMES])
    out = root / "D"
    cfg = cli_config(root / "D.json", inputs, out, TEXTURE_CODEC="uastc")
    seq = TEMPLATE["KTX2_BATCH_SIZE"]
    first = cli_encode(torch, cfg)
    before = tree(out)
    again = cli_encode(torch, cfg)
    check(tree(out) == before, "the second CLI run of project D wrote a file")
    manifest = str(out / "smoke.uvol.json")
    m = json.loads(open(manifest).read())
    check(list(m["texture"]["targets"]) == ["uastc-tpu"]
          and m["texture"]["targets"]["uastc-tpu"]["sequenceCount"] == -(-UASTC_FRAMES // seq),
          "project D's manifest texture target")
    sync, v2, decode_ms, play_launches = play(torch, manifest, False)
    ok = hold_playback(sync, v2, UASTC_FRAMES, seq)
    check({r.texture.format for r in sync if r.status == "ok"} == {"etc2-eac"},
          "project D did not play as etc2-eac")
    check(play_launches.get("etc1_encode", 0) >= 1, "project D's playback never launched K1")
    asyn, v2a, decode_ms_async, async_launches = play(torch, manifest, True)
    check(hold_playback(asyn, v2a, UASTC_FRAMES, seq) == ok, "the async run showed other frames")
    check(same_ticks(asyn, sync), "project D: the async ticks differ from the sync ones")
    # the card's transcode against the CPU's
    segs = sorted((out / "texture_uastc-tpu_baseColor_default").glob("*.ktx2"))
    compared = []
    for i, target in UASTC_CPU_TRANSCODES:
        f = read_ktx2(segs[i].read_bytes())
        t = time.perf_counter()
        card = transcode_uastc(f, target, device=DEVICE)
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        cpu = transcode_uastc(f, target, device="cpu")
        compared.append({"segment": i, "target": target, "shape": list(card.shape),
                         "card_s": card_s, "cpu_s": time.perf_counter() - t})
        check(card.dtype == cpu.dtype and np.array_equal(card, cpu),
              f"segment {i} to {target}: card words != CPU words")
    totals = {}
    for src in (first["launches"], play_launches, async_launches):
        for k, v in src.items():
            totals[k] = totals.get(k, 0) + v
    emit({"phase": "uastc_path", "project": "D",
          "config": {k: v for k, v in json.loads(open(cfg).read()).items()
                     if k in ("GEOMETRY_CODEC", "TEXTURE_CODEC", "KTX2_BATCH_SIZE",
                              "ENCODE_WORKERS", "Q_POSITION_ATTR", "Q_TEXTURE_ATTR",
                              "Q_NORMAL_ATTR")},
          "frames": UASTC_FRAMES, "size": [H, W], "files": sum(1 for p in out.rglob("*") if p.is_file()),
          "bytes": sum(len(b) for b, _ in tree(out).values()),
          "encode_s": first["wall_s"], "encode_fps": UASTC_FRAMES / first["wall_s"],
          "stage_s": first["stage_s"], "encode_launches": first["launches"],
          "second_run_s": again["wall_s"], "second_run_launches": again["launches"],
          "ticks": len(sync), "ok_ticks": ok,
          "statuses": {s: [r.status for r in sync].count(s) for s in sorted({r.status for r in sync})},
          "decode_ms": decode_ms, "decode_ms_async": decode_ms_async,
          "playback_launches": play_launches, "card_vs_cpu": compared,
          "launches": totals, "total_s": time.perf_counter() - t0})
    shutil.rmtree(root, ignore_errors=True)
    return totals


def sha256(*parts) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


def wall_ms(torch, fn, reps: int = REPS) -> float:
    """Median host-clock ms of `fn` to the end of its device work, after a
    warmup: for calls that block on the host (a collective over gloo)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def psnr_db(decoded: np.ndarray, frames: np.ndarray) -> float:
    mse = float(((decoded.astype(np.float64) - frames) ** 2).mean())
    return float(10 * np.log10(255.0**2 / mse))


def sequence_run(torch, batch: tuple, geo, texc_of) -> dict:
    """Encode and decode the bench batch and its ragged cut with the
    sequence codecs (mesh-sharded or not): hashes of every artifact and
    each encode's host-clock seconds, per cut."""
    from uvol_tpu_torch.models.sequence import GeometryFrameSet, read_ktx2

    positions, uvs, counts, faces, textures = batch
    out = {}
    for cut in (F, MD_RAGGED):
        fs = GeometryFrameSet(positions[:cut], uvs[:cut], counts[:cut], faces[:cut])
        texc = texc_of(cut)
        torch.cuda.synchronize()
        t = time.perf_counter()
        blobs = geo.encode(fs)
        geo_s = time.perf_counter() - t
        t = time.perf_counter()
        tex_blob = texc.encode_segment(textures[:cut])
        tex_s = time.perf_counter() - t
        dec = geo.decode(blobs)
        tdec = texc.decode_segment(read_ktx2(tex_blob))
        out[cut] = {"uvtg": sha256(*blobs), "ktx2": sha256(tex_blob),
                    "positions": sha256(dec.positions), "uvs": sha256(dec.uvs),
                    "layers": sha256(tdec), "encode_s": {"geometry": geo_s, "texture": tex_s}}
    return out


def etc1s_run(torch, textures, **kw) -> dict:
    """The ETC1S segment encoded twice at each of MD_PALETTES: bytes'
    hash, equal on the rerun, transcoded PSNR, seconds of each encode."""
    from uvol_tpu_torch.codecs.basis.etc1s_encode import (
        encode_ktx2_etc1s, read_ktx2, transcode_ktx2_etc1s)

    frames = textures[:ETC1S_LAYERS]
    out = {}
    for pal in MD_PALETTES:
        runs, secs = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            runs.append(encode_ktx2_etc1s(frames, num_endpoints=pal, num_selectors=pal, **kw))
            secs.append(time.perf_counter() - t)
        dec = transcode_ktx2_etc1s(read_ktx2(runs[0]))[..., :3]
        out[pal] = {"sha": sha256(runs[0]), "rerun_equal": runs[1] == runs[0],
                    "bytes": len(runs[0]), "psnr_db": psnr_db(dec, frames), "encode_s": secs}
    return out


def multidevice_rank() -> dict:
    """One rank of `multidevice_path` (spawned by `parallel.ranks.run_ranks`,
    its group already joined): the sequence codecs and the ETC1S segment
    encode over a mesh of every rank, each wrapper's launches from a reset
    just before to just after, the rank-ordered gather and sum timed, and
    what this process has loaded of JAX."""
    import torch
    import torch.distributed as dist

    from uvol_tpu_torch.models.sequence import GeometrySequenceCodec, TextureSequenceCodec
    from uvol_tpu_torch.parallel.mesh import (
        all_gather_in_rank_order, all_sum_in_rank_order, make_mesh, mesh_device, transport)

    mesh = make_mesh()
    dev = mesh_device(mesh)
    world = dist.get_world_size()
    batch = bench_batch()
    geo = GeometrySequenceCodec(11, 10, mesh=mesh)

    def texc_of(cut):
        return TextureSequenceCodec(sequence_size=cut, mesh=mesh)

    sequence_run(torch, batch, geo, texc_of)  # warmup: library, allocator
    reset_all_launches()
    seq = sequence_run(torch, batch, geo, texc_of)
    etc = etc1s_run(torch, batch[4], mesh=mesh)
    torch.cuda.synchronize()
    launches = all_launches()

    shard = torch.zeros((F // world, 3, N), dtype=torch.int32, device=dev)  # a symbols shard
    partial = torch.rand(MD_SUM_SHAPE, device=dev)
    ms = {"gather_ms": wall_ms(torch, lambda: all_gather_in_rank_order(mesh, shard)),
          "sum_ms": wall_ms(torch, lambda: all_sum_in_rank_order(mesh, partial)),
          "gather_bytes": shard.numel() * 4 * world, "sum_shape": list(MD_SUM_SHAPE)}
    if dist.get_backend() == "gloo":
        # the transport not taken: an int32 all_reduce over gloo on CUDA tensors
        # (a zero-filled [world, ...] buffer, this rank's row filled), timed
        # beside the host copies that `choose_transport` picks for gloo
        buf = torch.zeros((world, *shard.shape), dtype=torch.int32, device=dev)

        def reduce_gather():
            buf[dist.get_rank()] = shard
            dist.all_reduce(buf)

        ms["gloo_cuda_int_all_reduce_ms"] = wall_ms(torch, reduce_gather)
    return {"rank": dist.get_rank(), "world": world, "backend": dist.get_backend(),
            "transport": transport(mesh), "device": str(dev), "launches": launches,
            "sequence": seq, "etc1s": etc, "collectives": ms,
            "jax_loaded": sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "uvol_tpu"))}


def multidevice_path(torch, batch, t_start: float) -> dict:
    """The sequence codecs and the ETC1S segment encode with `mesh=` on
    ranks that share cuda:0: one rank (a one-rank NCCL group) and
    MD_SHARED ranks (gloo), against the one-device port run here first.
    Gates: the same `.uvtg`/`.ktx2` bytes and decodes as one device, the
    ETC1S bytes the same on every rank and on a rerun (one rank: one
    device's bytes) within 0.5 dB of one device's PSNR, every kernel of
    MD_KERNELS launched on every rank, no JAX in any rank. Returns the
    launches of each rank of the shared group."""
    from uvol_tpu_torch.models.sequence import GeometrySequenceCodec, TextureSequenceCodec
    from uvol_tpu_torch.parallel.ranks import run_ranks

    geo = GeometrySequenceCodec(11, 10, device=DEVICE)

    def texc_of(cut):
        return TextureSequenceCodec(cut, device=DEVICE)

    sequence_run(torch, batch, geo, texc_of)  # warmup, as each rank's
    one = {"sequence": sequence_run(torch, batch, geo, texc_of),
           "etc1s": etc1s_run(torch, batch[4], device=DEVICE)}
    groups = {}
    for n in (1, MD_SHARED):
        t = time.perf_counter()
        ranks = run_ranks(multidevice_rank, n, device_type="cuda", timeout=MD_TIMEOUT)
        wall_s = time.perf_counter() - t
        backend = "nccl" if n == 1 else "gloo"
        for res in ranks:
            check(res["backend"] == backend, f"{n} ranks ran over {res['backend']}, not {backend}")
            check(res["transport"] == ("device" if n == 1 else "host"), "transport")
            check(not res["jax_loaded"], f"rank {res['rank']} loaded {res['jax_loaded'][:5]}")
            for k in MD_KERNELS:
                check(res["launches"].get(k, 0) >= 1, f"rank {res['rank']} of {n} never "
                      f"launched {k} on the multi-device path")
            for cut, want in one["sequence"].items():
                got = res["sequence"][cut]
                for key in ("uvtg", "ktx2", "positions", "uvs", "layers"):
                    check(got[key] == want[key], f"{n} ranks, {cut} frames: {key} differs "
                          "from one device's")
            for pal, want in one["etc1s"].items():
                got = res["etc1s"][pal]
                check(got["rerun_equal"], f"{n} ranks, {pal}/{pal}: a rerun changed the bytes")
                check(got["sha"] == ranks[0]["etc1s"][pal]["sha"],
                      f"{n} ranks, {pal}/{pal}: the ranks' ETC1S bytes differ")
                check(abs(got["psnr_db"] - want["psnr_db"]) < 0.5,
                      f"{n} ranks, {pal}/{pal}: PSNR {got['psnr_db']:.2f} against one "
                      f"device's {want['psnr_db']:.2f}")
                if n == 1:
                    check(got["sha"] == want["sha"], f"one rank, {pal}/{pal}: bytes differ "
                          "from one device's")
        groups[n] = {
            "backend": backend, "wall_s": wall_s,
            "launches": [{k: res["launches"][k] for k in MD_KERNELS + ("etc1s_rate_sweep",)}
                         for res in ranks],
            "collectives": [res["collectives"] for res in ranks],
            "encode_s": [{"sequence": {cut: v["encode_s"] for cut, v in res["sequence"].items()},
                          "etc1s": {pal: v["encode_s"] for pal, v in res["etc1s"].items()}}
                         for res in ranks],
            "etc1s": {pal: {k: ranks[0]["etc1s"][pal][k] for k in ("bytes", "psnr_db")}
                      for pal in MD_PALETTES},
        }
    emit({"phase": "multidevice_path",
          "note": "ranks share one card (cuda:0): these are not scaling figures",
          "frames": [F, MD_RAGGED], "vertices": N, "layers": [F, MD_RAGGED], "size": [H, W],
          "etc1s_segment": [ETC1S_LAYERS, H, W], "palettes": list(MD_PALETTES),
          "one_device": {
              "encode_s": {"sequence": {cut: v["encode_s"]
                                        for cut, v in one["sequence"].items()},
                           "etc1s": {pal: v["encode_s"] for pal, v in one["etc1s"].items()}},
              "etc1s": {pal: {k: v[k] for k in ("bytes", "psnr_db")}
                        for pal, v in one["etc1s"].items()}},
          "ranks": {str(n): g for n, g in groups.items()},
          "total_s": time.perf_counter() - t_start})
    return {k: [lr[k] for lr in groups[MD_SHARED]["launches"]] for k in MD_KERNELS}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    # the port; alone in a directory this import fails before any output
    from uvol_tpu_torch import _build
    from uvol_tpu_torch.codecs.basis import etc as tetc
    from uvol_tpu_torch.codecs.basis import etc_cuda
    from uvol_tpu_torch.models.sequence import (
        GeometryFrameSet,
        GeometrySequenceCodec,
        TextureSequenceCodec,
        decode_device,
        encode_device,
        host_rans_is_native,
        read_ktx2,
    )
    from uvol_tpu_torch.codecs.basis.etc1s_encode import encode_ktx2_etc1s
    from uvol_tpu_torch._device import true_div
    from uvol_tpu_torch.ops.pallas_kernels import quantize_offsets
    from uvol_tpu_torch.ops import pallas_kernels as pk
    from uvol_tpu_torch.utils.timing import cuda_timer, device_time_ms, median_cuda_ms

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()
    check_full_f32()

    # ---- 1. environment ------------------------------------------------------
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "native_rans_loaded": host_rans_is_native()})

    # ---- 2. build --------------------------------------------------------------
    t = time.perf_counter()
    so = _build.build()
    _build.get_lib()
    emit({"phase": "build", "library": str(so.relative_to(so.parents[2])),
          "seconds": time.perf_counter() - t})

    # ---- 3. kernel parity: kernel (CUDA) vs plain twin on CUDA and on CPU -----
    positions, uvs, counts, faces, textures = bench_batch()
    r = np.random.default_rng(1)
    bb = boundary_blocks()
    enc_inputs = {
        "bench_texture_4x1024": textures[:4],
        "random_blocks": r.integers(0, 256, (1, PARITY_SIDE, PARITY_SIDE, 3),
                                    dtype=np.uint8),
        "boundary_blocks": tetc.blocks_to_image(torch.from_numpy(bb)[None], 4,
                                                4 * len(bb)).numpy(),
    }
    err = {"etc1_encode": 0, "etc1_decode": 0}
    dec_inputs = {}
    for name, img in enc_inputs.items():
        x = torch.from_numpy(np.ascontiguousarray(img))
        got = etc_cuda.encode_etc1_images(x.to(dev))
        twin_dev = etc_cuda.encode_etc1_images_plain(x.to(dev))
        twin_cpu = etc_cuda.encode_etc1_images_plain(x)
        got_h = got.cpu().to(torch.int64)
        e = max(int((got_h - twin_dev.cpu()).abs().max()),
                int((got_h - twin_cpu).abs().max()))
        check(e == 0, f"K1 differs from its plain twin on {name}")
        err["etc1_encode"] = max(err["etc1_encode"], e)
        dec_inputs[name] = (got.cpu(), img.shape[:3])
    for l, h, w in K2_RANDOM_SHAPES:
        rw = r.integers(0, 2**32, (l * (h // 4) * (w // 4), 2), dtype=np.uint32)
        dec_inputs[f"random_words_{l}x{h}x{w}"] = (torch.from_numpy(rw.view(np.int32)), (l, h, w))
    for name, (words, (l, h, w)) in dec_inputs.items():
        wd = words.to(dev)
        # the same words 8 bytes into a 16-byte-aligned buffer: the least
        # alignment a contiguous [M, 2] int32 slice has
        shifted = torch.cat([wd[:1], wd])[1:]
        check(shifted.data_ptr() % 16 == 8, "the shifted words are not 8-byte aligned")
        twins = [etc_cuda.decode_etc1_images_plain(wd, l, h, w).cpu()]
        if l * h * w <= PARITY_SIDE * PARITY_SIDE * 4:  # the CPU twin too, where it is quick
            twins.append(etc_cuda.decode_etc1_images_plain(words, l, h, w))
        for src in (wd, shifted):
            got = etc_cuda.decode_etc1_images(src, l, h, w).cpu()
            for tw in twins:
                e = int((got.to(torch.int16) - tw.to(torch.int16)).abs().max())
                check(e == 0, f"K2 differs from its plain twin on {name}")
                err["etc1_decode"] = max(err["etc1_decode"], e)
    emit({"phase": "kernel_parity", "inputs_k1": list(enc_inputs),
          "inputs_k2": list(dec_inputs), "max_abs_err": err})
    err.update(etc1s_parity(torch, dev, textures, bb))
    err.update(k3_parity(torch, dev, positions, uvs))

    # ---- 4. main path at full width ---------------------------------------------
    frames = GeometryFrameSet(positions, uvs, counts, faces)
    geo = GeometrySequenceCodec(position_bits=11, uv_bits=10, device=DEVICE)
    texc = TextureSequenceCodec(sequence_size=F, device=DEVICE)

    def encode_all():
        return geo.encode(frames), texc.encode_segment(textures)

    def decode_all(blobs, tex_blob):
        return (geo.decode(blobs, as_numpy=False),
                texc.decode_segment(read_ktx2(tex_blob), as_numpy=False))

    decode_all(*encode_all())  # warmup: allocator, library load
    etc_cuda.reset_launches()
    pk.reset_launches()
    blobs, tex_blob = encode_all()
    dec, tex_dec = decode_all(blobs, tex_blob)
    torch.cuda.synchronize()
    launches = {**etc_cuda.LAUNCHES, **pk.LAUNCHES}
    for k, v in launches.items():
        check(v >= 1, f"main path never launched {k}")
    # one geometry encode: the minimum/maximum and K3 on the positions, then on the UVs
    for k in ("geometry_minmax", "quantize_delta_zigzag"):
        check(launches[k] == 2, f"the geometry encode did not launch {k} twice")

    # geometry: bytes equal to the CPU codec's, error within one step
    geo_cpu = GeometrySequenceCodec(position_bits=11, uv_bits=10, device="cpu")
    check(geo_cpu.encode(frames) == blobs, ".uvtg bytes differ between CUDA and CPU")
    dec_cpu = geo_cpu.decode(blobs, as_numpy=False)
    check(tuple(dec.positions.shape) == (F, 3, N), "decoded positions shape")
    pos_dev = dec.positions.cpu()
    check(bool(torch.isfinite(pos_dev).all()), "non-finite decoded positions")
    geo_err = float((pos_dev - dec_cpu.positions).abs().max())
    uv_err = float((dec.uvs.cpu() - dec_cpu.uvs).abs().max())
    # same float32 ops in the same order on both devices: expected 0
    check(geo_err == 0.0 and uv_err == 0.0, "decoded floats differ CUDA vs CPU")
    step = float((positions[0].max(0) - positions[0].min(0)).max()) / 2047
    pos_err = float(np.abs(pos_dev[0].numpy().T - positions[0]).max())
    check(pos_err <= step, f"position error {pos_err} > step {step}")

    # texture: bytes equal to the plain twin on CUDA (32 layers) and to the
    # CPU codec (2 layers); pixels equal to the plain twin's decode
    tex_dev = torch.from_numpy(textures).to(dev)
    words_plain = etc_cuda.encode_etc1_images_plain(tex_dev)
    check(texc.segment_from_words(words_plain, F, H, W) == tex_blob,
          ".ktx2 bytes differ between K1 and its plain twin")
    check(bool(torch.equal(etc_cuda.decode_etc1_images_plain(words_plain, F, H, W),
                           tex_dec)), "decoded layers differ from the plain twin")
    tex2_cuda = TextureSequenceCodec(sequence_size=2, device=DEVICE)
    tex2_cpu = TextureSequenceCodec(sequence_size=2, device="cpu")
    check(tex2_cuda.encode_segment(textures[:2]) == tex2_cpu.encode_segment(textures[:2]),
          ".ktx2 bytes differ between CUDA and CPU at 2 layers")
    check(tuple(tex_dec.shape) == (F, H, W, 3) and tex_dec.dtype == torch.uint8,
          "decoded texture shape")
    mse = float(((tex_dec.float() - tex_dev.float()) ** 2).mean())
    psnr = 10 * np.log10(255.0**2 / mse)
    check(psnr > 30.0, f"texture PSNR {psnr:.2f} dB")
    # the device stage of one geometry encode is those 4 kernels and nothing else
    dev_pos = torch.from_numpy(positions.transpose(0, 2, 1).copy()).to(dev)
    dev_uv = torch.from_numpy(uvs.transpose(0, 2, 1).copy()).to(dev)
    dev_mask = torch.ones((F, N), dtype=torch.bool, device=dev)
    stage_kernels = launches_per_call(
        torch, lambda: encode_device(dev_pos, dev_uv, dev_mask, 11, 10), STAGE_KERNEL_NAMES)
    check(stage_kernels == ENCODE_DEVICE_KERNELS,
          f"encode_device ran {stage_kernels} device kernels, not {ENCODE_DEVICE_KERNELS}")
    emit({"phase": "main_path", "frames": F, "vertices": N, "layers": F,
          "size": [H, W], "launches": launches, "encode_device_kernels": stage_kernels,
          "uvtg_bytes": sum(map(len, blobs)),
          "ktx2_bytes": len(tex_blob), "pos_err": pos_err, "step": step,
          "cuda_vs_cpu_max_abs_err": {"positions": geo_err, "uvs": uv_err},
          "texture_psnr_db": psnr})
    etc1s_launches, main_err, inten_args = etc1s_main_path(torch, textures)
    launches.update(etc1s_launches)

    # ---- 5. times (CUDA events, median of REPS after one warmup) -----------------
    words = etc_cuda.encode_etc1_images(tex_dev)
    ms = {
        "etc1_encode": median_cuda_ms(lambda: etc_cuda.encode_etc1_images(tex_dev), REPS),
        "etc1_encode_plain": median_cuda_ms(
            lambda: etc_cuda.encode_etc1_images_plain(tex_dev), REPS),
        "etc1_decode": median_cuda_ms(
            lambda: etc_cuda.decode_etc1_images(words, F, H, W), REPS),
        "etc1_decode_plain": median_cuda_ms(
            lambda: etc_cuda.decode_etc1_images_plain(words, F, H, W), REPS),
    }
    traced = {}  # launches the profiler held per kernel, of REPS calls
    ms["etc1_encode_kernel"], traced["etc1_encode"] = kernel_only_ms(
        torch, lambda: etc_cuda.encode_etc1_images(tex_dev), WRAPPER_KERNELS["etc1_encode"])
    ms["etc1_decode_kernel"], traced["etc1_decode"] = kernel_only_ms(
        torch, lambda: etc_cuda.decode_etc1_images(words, F, H, W),
        WRAPPER_KERNELS["etc1_decode"])

    def device_chain():
        out = encode_device(dev_pos, dev_uv, dev_mask, 11, 10)
        w = etc_cuda.encode_etc1_images(tex_dev)
        pos2, uv2 = decode_device(
            out["pos_syms"], out["pos_min"], true_div(out["pos_range"], 2047.0),
            out["uv_syms"], out["uv_min"], true_div(out["uv_range"], 1023.0),
        )
        return pos2, uv2, etc_cuda.decode_etc1_images(w, F, H, W)

    # the geometry stage at the geometry encode's shapes, positions and UVs:
    # the stage, its two halves, and K3 with its offsets given (the old
    # figures' names). Each a call (CUDA events, launch included), a call
    # in a loop of back-to-back launches, and the kernels alone (profiler
    # device time per launch)
    for part, a, bits in (("", dev_pos, 11), ("_uv", dev_uv, 10)):
        xm, inv = quantize_offsets(a, bits, dev_mask)[:2]
        bounds = pk.geometry_minmax(a, dev_mask)
        for key, fn, twin, names in (
            ("quantize_delta_zigzag", lambda: pk.fused_quantize_delta_zigzag(xm, inv),
             lambda: pk.fused_quantize_delta_zigzag_plain(xm, inv), (K3_KERNEL_NAME,)),
            ("geometry_stage", lambda: pk.geometry_quantize_stage(a, dev_mask, bits),
             lambda: pk.geometry_quantize_stage_plain(a, dev_mask, bits), STAGE_KERNEL_NAMES),
            ("geometry_minmax", lambda: pk.geometry_minmax(a, dev_mask),
             lambda: pk.geometry_minmax_plain(a, dev_mask), (MINMAX_KERNEL_NAME,)),
            ("quantize_from_bounds", lambda: pk.quantize_from_bounds(a, dev_mask, *bounds, bits),
             lambda: pk.quantize_from_bounds_plain(a, dev_mask, *bounds, bits),
             (K3_KERNEL_NAME,)),
        ):
            ms[f"{key}{part}"] = median_cuda_ms(fn, REPS)
            ms[f"{key}{part}_plain"] = median_cuda_ms(twin, REPS)
            with cuda_timer() as t:
                for _ in range(K3_PROFILED_LAUNCHES):
                    fn()
            ms[f"{key}{part}_in_loop"] = t.ms / K3_PROFILED_LAUNCHES
            ms[f"{key}{part}_kernel"], traced[f"{key}{part}"] = kernel_only_ms(
                torch, fn, names, K3_PROFILED_LAUNCHES)
    # the stage's kernels on the positions with the 50 MB L2 cache overwritten
    # before each call (K3 then finds what the minimum/maximum just read), and
    # what the event pair around an empty call reads: the floor under every
    # per-call figure
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def stage_cold():
        flush.zero_()
        return pk.geometry_quantize_stage(dev_pos, dev_mask, 11)

    for key, name in (("geometry_minmax", MINMAX_KERNEL_NAME),
                      ("quantize_from_bounds", K3_KERNEL_NAME)):
        ms[f"{key}_kernel_l2_cold"], _ = kernel_only_ms(torch, stage_cold, (name,))
    del flush
    ms["event_pair_floor"] = median_cuda_ms(lambda: None, REPS)
    ms["device_chain"] = median_cuda_ms(device_chain, REPS)
    ms["host_encode"] = median_cuda_ms(encode_all, REPS)
    ms["host_decode"] = median_cuda_ms(lambda: decode_all(blobs, tex_blob), REPS)
    fps = {k: F / (ms[k] / 1e3) for k in ("device_chain", "host_encode", "host_decode")}
    emit({"phase": "times", "frames": F, "reps": REPS, "ms": ms, "frames_per_s": fps,
          "kernel_launches_traced": traced})
    etc1s_ms, times_err, inten_ops = etc1s_times(
        torch, dev, textures, inten_args, median_cuda_ms)
    ms.update(etc1s_ms)
    builds_err, builds_ms = segment_sum_builds(torch, dev, textures, median_cuda_ms)
    ms.update(builds_ms)
    for e in (main_err, times_err, builds_err):  # the kernels line: the worst of every comparison
        for name, v in e.items():
            err[name] = max(err[name], v)

    # ---- 6. the real-.drc device decode at liam scale (K8's main path), before the
    # profile and the 1024/1024 path: late in a run the profiler drops more events
    drc_launches, drc_err, drc_ms, drc_args = drc_device_path(
        torch, dev, positions, uvs, median_cuda_ms)
    launches.update(drc_launches)
    ms.update(drc_ms)
    err.update(drc_err)

    # ---- 7. one torch.profiler pass per host-inclusive stage ------------------
    # wall_ms includes the profiler's own overhead; device_ms sums the
    # device-side events (one stream, so they do not overlap)
    stages = {
        "geometry_encode": lambda: geo.encode(frames),
        "texture_encode": lambda: texc.encode_segment(textures),
        "geometry_decode": lambda: geo.decode(blobs, as_numpy=False),
        "texture_decode": lambda: texc.decode_segment(read_ktx2(tex_blob), as_numpy=False),
        "etc1s_segment_encode": lambda: encode_ktx2_etc1s(
            textures[:ETC1S_LAYERS], num_endpoints=ETC1S_PALETTE,
            num_selectors=ETC1S_PALETTE, device=DEVICE),
        "etc1s_delta_segment_encode": lambda: encode_ktx2_etc1s(
            textures[:ETC1S_LAYERS], num_endpoints=ETC1S_DELTA_PALETTE,
            num_selectors=ETC1S_DELTA_PALETTE, device=DEVICE),
    }
    profile = {}
    for name, fn in stages.items():
        fn()  # untraced first: the trace holds a warm pass
        for attempt in range(TRACE_ATTEMPTS):
            with padded_trace(torch) as prof:
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
            by_name = {k: v for k, v in device_time_ms(prof).items() if PAD_KERNEL not in k}
            if by_name:
                break
            TRACES_RETAKEN.append([name])
            emit({"phase": "trace_retaken", "attempt": attempt + 1, "missing": [name]})
        check(by_name, f"the profiler saw no device event of {name}")
        kinds = {"h2d": 0.0, "d2h": 0.0, "k3_kernel": 0.0, "minmax_kernel": 0.0,
                 "etc1_kernels": 0.0, "etc1s_kernels": 0.0, "other": 0.0}
        for k, v in by_name.items():
            kind = ("h2d" if k.startswith("Memcpy HtoD") else
                    "d2h" if k.startswith("Memcpy DtoH") else
                    "k3_kernel" if K3_KERNEL_NAME in k else
                    "minmax_kernel" if MINMAX_KERNEL_NAME in k else
                    "etc1_kernels" if "etc1_" in k else
                    "etc1s_kernels" if any(kn in k for kn in ETC1S_KERNEL_NAMES) else "other")
            kinds[kind] += v
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        profile[name] = {
            "wall_ms": wall, "device_ms": kinds, "device_busy_share": busy / wall,
            "host_ms": wall - busy, "top": [[k[:80], v] for k, v in top],
        }
    emit({"phase": "profile", "stages": profile, "traces_retaken": TRACES_RETAKEN,
          "total_s": time.perf_counter() - t_start})

    # ---- 8. the delta-aware stage at the CLI's 1024/1024 (K7's main path) --------
    delta_launches, delta_err, delta_ms = etc1s_delta_path(torch, dev, textures, median_cuda_ms)
    ms.update(delta_ms)
    launches["etc1s_rate_sweep"] = delta_launches["etc1s_rate_sweep"]
    for name, v in delta_err.items():
        err[name] = max(err.get(name, 0), v)

    # ---- 9. UASTC: U1 at the main path's size (traced, so before the CLI's
    # runs), then project D: the CLI's `uastc` codec and the player's etc2-eac
    # refit through K1, which reads only the wrappers' counters
    uastc_launches, uastc_err, uastc_ms = uastc_device_fit_path(torch, dev, textures,
                                                                median_cuda_ms)
    launches.update(uastc_launches)
    ms.update(uastc_ms)
    err.update(uastc_err)

    # ---- 9b. the point-cloud, trajectory, normals and parallelogram paths
    # (U3-U5), after every phase but its own that reads a trace: run before
    # `profile`, it left that phase's texture-encode traces empty five times
    pc_launches, pc_err, pc_ms, pc_work = pointcloud_trajectory_path(torch, dev, median_cuda_ms)
    launches.update(pc_launches)
    ms.update(pc_ms)
    err.update(pc_err)

    # ---- 9c. palettes past one window of the kernels and U5 past its shared
    # prefix (CUDA events, no trace), then the copied Python Draco decoder
    wide_err, wide_ms, wide, wide_launches = wide_palette_path(torch, dev, textures,
                                                               median_cuda_ms)
    for name, v in wide_err.items():
        err[name] = max(err.get(name, 0), v)
    ms.update(wide_ms)
    python_draco_path(torch, textures)
    uastc_cli_launches = uastc_project_path(torch, textures)

    # ---- 10. the port's entry points: the encoder CLI and the player. Last: it
    # reads the wrappers' counters, no trace, and run before `profile` it left that
    # phase's texture-encode traces empty five times in a row (PERF.md section 6)
    cli_launches = cli_player_path(torch, textures)
    for k, v in uastc_cli_launches.items():
        cli_launches[k] = cli_launches.get(k, 0) + v

    # ---- 11. multi-device: the codecs with `mesh=` on ranks sharing the card (one
    # NCCL rank, then MD_SHARED gloo ranks), each in a process of its own
    md_launches = multidevice_path(torch, (positions, uvs, counts, faces, textures), t_start)

    # ---- 12. the kernels line: main-path launches, parity, times, bounds ------
    nb = F * (H // 4) * (W // 4)  # K1/K2: 32 layers of 1024^2
    nq = F * 3 * N  # K3: the positions call
    ne = ETC1S_LAYERS * (H // 4) * (W // 4)  # K4-K6: 327,680 blocks
    e = ETC1S_PALETTE
    sn, sk, sd = SEG_TIMED
    nr, er = (H // 4) * (W // 4), ETC1S_DELTA_PALETTE  # K7: one frame at 1024 entries
    sweep_rows = ETC1S_DELTA_PALETTE  # its selector rows
    # K8: the main path's window of DRC_WINDOW frames, every float it writes
    drc_out = sum(f * nmax * (nc if kind == 1 else 3)
                  for _t, kind, _m, f, nmax, nc, *_r in drc_args[1])
    # U1: the main path's 2,097,152 blocks with the default RGB pair
    from uvol_tpu_torch.codecs.basis.uastc import MODES as UASTC_MODES

    nu = F * (H // 4) * (W // 4)
    fpc, npc = pc_work["cloud"][0], pc_work["cloud"][0] * pc_work["cloud"][1]
    nch, dch = pc_work["chain"][0] * pc_work["chain"][1], pc_work["chain"][2]
    u1_ops = uastc_fit_ops([UASTC_MODES[m] for m in UASTC_MODE_SETS["rgb"]])
    work = {  # name: (source, replaces, bytes moved once, operations, their rate)
        "etc1_encode": ("etc1.cu", "codecs/basis/etc_pallas.py:230", nb * 48 + nb * 8,
                        OPS["etc1_encode"] * nb, INT_OPS_PER_S),
        "etc1_decode": ("etc1.cu", "codecs/basis/etc_pallas.py:350", nb * 8 + nb * 48,
                        OPS["etc1_decode"] * nb * 16, INT_OPS_PER_S),
        # K3 as the main path calls it: the attributes, the mask and the bounds in,
        # the symbols and the range out
        "quantize_delta_zigzag": ("geometry.cu", "ops/pallas_kernels.py:68",
                                  nq * 4 + F * N + 2 * F * 3 * 4 + nq * 4 + F * 4,
                                  OPS["quantize_delta_zigzag"] * nq, INT_OPS_PER_S),
        # the reference's masked minimum and maximum are XLA reductions, not a Pallas site
        "geometry_minmax": ("geometry.cu", "models/sequence.py:146-151",
                            nq * 4 + F * N + 2 * F * 3 * 4,
                            OPS["geometry_minmax"] * nq, INT_OPS_PER_S),
        "etc1s_assign_endpoints": ("etc1s.cu", "codecs/basis/etc1s_pallas.py:149",
                                   ne * 48 + e * 80 + ne * 4,
                                   OPS["etc1s_assign_endpoints"] * ne * e, INT_OPS_PER_S),
        "etc1s_inten_errors": ("etc1s.cu", "codecs/basis/etc1s_pallas.py:217",
                               ne * 48 + ne * 12 + ne * 32,
                               inten_ops, INT_OPS_PER_S),  # an FFMA counts as an IMAD does
        "etc1s_kmeans_iter": ("etc1s.cu", "codecs/basis/etc1s_pallas.py:310",
                              ne * 16 + e * 16 + ne * 4 + e * 20,
                              OPS["etc1s_kmeans_iter"] * ne * e, F32_FLOP_PER_S),
        # the reference's segment sums are XLA one-hot products, not a Pallas site
        "etc1s_segment_sum": ("etc1s.cu", "codecs/basis/etc1s_encode.py:103",
                              sn * (sd + 1) * 4 + sk * sd * 4,
                              OPS["etc1s_segment_sum"] * sn * sd, F32_FLOP_PER_S),
        # the reference's frame body is XLA (a product and a lax.scan), not a
        # Pallas site: the blocks, the palette (colors, modifiers, bits, the
        # selector rows) and 4 assignment vectors in, 2 out; no [nb, E] tile
        "etc1s_rate_sweep": ("etc1s.cu", "codecs/basis/etc1s_encode.py:1211",
                             nr * 48 + er * (12 + 16 + 4) + sweep_rows * 64 + nr * 4 * 4
                             + nr * 2 * 4,
                             OPS["etc1s_rate_sweep"] * nr * er, INT_OPS_PER_S),
        # the reference's device stage is one XLA program, not a Pallas site: the
        # packed window (values and metadata) in once, every float written once
        "drc_fused_batch": ("drc.cu", "models/drc_device.py:193",
                            drc_args[0].numel() + drc_out * 4,
                            OPS["drc_fused_batch"] * drc_out, INT_OPS_PER_S),
        # the reference's fit is one XLA program, not a Pallas site: each block's
        # 64 bytes in once; the winner's index, endpoints (2 x 4 bytes), weight
        # planes (2 x 16) and error (4) out once
        "uastc_device_fit": ("uastc.cu", "codecs/basis/uastc.py:609",
                             nu * 64 + nu * (1 + 8 + 32 + 4), u1_ops * nu, INT_OPS_PER_S),
        # U3-U5 replace XLA programs of the reference, not Pallas sites. U3 per
        # frame: the positions and faces in once, the normals out once (the
        # wrapper's CSR is not the function's traffic)
        "estimate_normals": ("mesh_ops.cu", "ops/normals.py:66",
                             pc_work["nv"] * 24 + pc_work["nf"] * 12,
                             estimate_normals_ops(pc_work["nv"], pc_work["nf"]), F32_FLOP_PER_S),
        # U4 at a captured cloud's scale: the points in, the keys out
        "morton_keys": ("mesh_ops.cu", "models/pointcloud.py:31", npc * 12 + npc * 8 + fpc * 16,
                        OPS["morton_keys"] * npc, INT_OPS_PER_S),
        # U5 on the positions: residuals and index triples in, values out
        "parallelogram_decode": ("mesh_ops.cu", "ops/prediction.py:56",
                                 nch * dch * 8 + nch * 12, OPS["parallelogram_decode"] * nch * dch,
                                 INT_OPS_PER_S),
    }
    attrs = _build.kernel_attrs()
    for fn in ("etc1_encode_kernel", "etc1_decode_kernel", "inten_errors_kernel",
               "rate_sweep_frame_kernel", "drc_fused_batch_kernel", "uastc_device_fit_kernel",
               "weight_index_kernel", "seg_sum_chunk_kernel", "seg_sum_tree_kernel",
               "seg_sum_tree_kernel_small", "estimate_normals_kernel", "morton_keys_kernel",
               "parallelogram_decode_kernel", *STAGE_KERNEL_NAMES):
        check(attrs[fn]["stack_bytes"] == 0, f"{fn} uses stack memory")
    # K3's times are those of the call the main path makes (offsets taken in)
    timed_as = {"quantize_delta_zigzag": "quantize_from_bounds"}
    rows = []
    for name, (src, replaces, nbytes, ops, rate) in work.items():
        bound_ms, bound_by = bound(nbytes, ops, rate)
        timed = timed_as.get(name, name)
        rows.append({
            "name": name, "route": "cuda", "source": f"uvol_tpu_torch/csrc/{src}",
            "replaces": f"uvol_tpu/{replaces}", "launches": launches[name],
            "launches_cli_player": cli_launches.get(name, 0),
            # each of the MD_SHARED ranks' launches on the multi-device path
            "launches_multidevice": md_launches.get(name),
            "max_abs_err": err[name], "ms": ms[timed], "plain_ms": ms[timed + "_plain"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            # index_add_ for the segment sum and for U3's sums (in no fixed
            # order); for K7 the error product `feat @ mat.T`, the one piece
            # of its stage a library call computes; no single PyTorch call
            # computes any of the others
            # (none takes a mask, sums in a fixed order, scans a column at a
            # time, unpacks bit-packed values or fits a UASTC block's modes)
            "library_ms": ms.get(name + "_library"),
            "kernel_ms": ms[timed + "_kernel"],
            "kernel_attrs": {fn: attrs[fn] for fn in WRAPPER_KERNELS[name]},
        })
    # U5's other bound: its steps one after another, each waiting out
    # U5_STEP_CYCLES; U4's stable sort of the keys, a PyTorch call of the codec
    extra = {"parallelogram_decode": {"chain_bound_ms": pc_work["chain"][1] * U5_STEP_CYCLES
                                      / SM_CLOCK_HZ * 1e3},
             "morton_keys": {"sort_ms": ms["morton_keys_sort"]}}
    for row in rows:
        row.update(extra.get(row["name"], {}))
        if row["name"] in wide:  # the wide shapes' times and bounds, and launches
            row["wide"] = wide[row["name"]]
            if row["name"] in wide_launches:
                row["wide"]["launches_segment"] = wide_launches[row["name"]]
    check_full_f32()
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": rows})
    check_no_jax_loaded()
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
