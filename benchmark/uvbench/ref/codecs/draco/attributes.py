# Frozen copy of the program's `codecs/draco/attributes.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""Draco-format attribute decoding: prediction schemes + transforms.

The port's copy of `uvol_tpu/codecs/draco/attributes.py`, unchanged in what it emits; it
calls the port's own native library (`uvbench.ref.native`).

Implements the sequential attribute decoders and the integer prediction
machinery of the Draco bitstream:
  - wrap transform (modular corrections)
  - difference & (multi-)parallelogram prediction
  - portable texture-coordinate prediction (exact int64 geometry)
  - geometric normal prediction with the canonicalized octahedron transform

All integer arithmetic follows C++ semantics (division truncates toward
zero) — load-bearing for bit-exact reconstruction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

from uvbench.ref.codecs.buffer import DecoderBuffer
from uvbench.ref.codecs.draco import constants as K
from uvbench.ref.codecs.draco.corner_table import (
    INVALID,
    CornerTable,
    MeshAttributeCornerTable,
    next_corner,
    previous_corner,
)
from uvbench.ref.codecs.rans import RansBitDecoder
from uvbench.ref.codecs.symbol_coding import (
    convert_symbols_to_signed,
    decode_symbols,
)


def tdiv(a: int, b: int) -> int:
    """C++-style integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


# ---------------------------------------------------------------------------
# Wrap transform
# ---------------------------------------------------------------------------


class WrapTransform:
    """Corrections stored modulo the value range (positive symbols)."""

    def __init__(self, buf: DecoderBuffer):
        self.min_value = int(np.frombuffer(buf.raw(4), "<i4")[0])
        self.max_value = int(np.frombuffer(buf.raw(4), "<i4")[0])
        self.max_dif = 1 + self.max_value - self.min_value

    def compute_original(self, pred: np.ndarray, corr: np.ndarray) -> np.ndarray:
        pred = np.clip(pred, self.min_value, self.max_value)
        orig = pred + corr
        orig = np.where(orig > self.max_value, orig - self.max_dif, orig)
        orig = np.where(orig < self.min_value, orig + self.max_dif, orig)
        return orig


# ---------------------------------------------------------------------------
# Octahedron tool box (integer, Draco semantics)
# ---------------------------------------------------------------------------


class OctahedronToolBox:
    def __init__(self, quantization_bits: int):
        self.q = quantization_bits
        self.max_quantized_value = (1 << quantization_bits) - 1
        self.max_value = self.max_quantized_value - 1
        self.center_value = self.max_value // 2

    def mod_max(self, x: int) -> int:
        if x > self.center_value:
            return x - self.max_quantized_value
        if x < -self.center_value:
            return x + self.max_quantized_value
        return x

    def is_in_diamond(self, s: int, t: int) -> bool:
        return abs(s) + abs(t) <= self.center_value

    def invert_diamond(self, s: int, t: int):
        if s >= 0 and t >= 0:
            sign_s, sign_t = 1, 1
        elif s <= 0 and t <= 0:
            sign_s, sign_t = -1, -1
        else:
            sign_s = 1 if s > 0 else -1
            sign_t = 1 if t > 0 else -1
        corner_s = sign_s * self.center_value
        corner_t = sign_t * self.center_value
        s = 2 * s - corner_s
        t = 2 * t - corner_t
        if sign_s * sign_t >= 0:
            s, t = -t, -s
        else:
            s, t = t, s
        s = (s + corner_s) // 2
        t = (t + corner_t) // 2
        return s, t

    @staticmethod
    def is_in_bottom_left(s: int, t: int) -> bool:
        if s == 0 and t == 0:
            return True
        return s < 0 and t <= 0

    @staticmethod
    def get_rotation_count(s: int, t: int) -> int:
        if s == 0:
            if t == 0:
                return 0
            return 3 if t > 0 else 1
        if s > 0:
            return 2 if t >= 0 else 1
        return 0 if t <= 0 else 3

    @staticmethod
    def rotate_point(s: int, t: int, rotation_count: int):
        if rotation_count == 1:
            return t, -s
        if rotation_count == 2:
            return -s, -t
        if rotation_count == 3:
            return -t, s
        return s, t

    def canonicalize_integer_vector(self, v: List[int]) -> List[int]:
        """Scale an int64 vector so |x|+|y|+|z| equals a fixed large sum."""
        max_sum = (1 << 30) - 1  # Draco's kMaxQuantizedValue-ish precision
        abs_sum = abs(v[0]) + abs(v[1]) + abs(v[2])
        if abs_sum == 0:
            return [max_sum, 0, 0]
        return [tdiv(v[0] * max_sum, abs_sum),
                tdiv(v[1] * max_sum, abs_sum),
                tdiv(v[2] * max_sum, abs_sum)]

    def integer_vector_to_quantized_octahedral_coords(self, v: Sequence[int]):
        abs_sum = abs(v[0]) + abs(v[1]) + abs(v[2])
        if abs_sum == 0:
            s = t = 0
        elif v[2] >= 0:
            s, t = v[0], v[1]
        else:
            s = (1 if v[0] >= 0 else -1) * (abs_sum - abs(v[1]))
            t = (1 if v[1] >= 0 else -1) * (abs_sum - abs(v[0]))
        if abs_sum == 0:
            return self.center_value, self.center_value
        # round((x/abs_sum + 1)/2 * max_value): all quantities positive
        qs = ((s + abs_sum) * self.max_value + abs_sum) // (2 * abs_sum)
        qt = ((t + abs_sum) * self.max_value + abs_sum) // (2 * abs_sum)
        return int(qs), int(qt)

    def quantized_octahedral_coords_to_unit_vector(self, s: int, t: int):
        u = s / self.max_value * 2.0 - 1.0
        v = t / self.max_value * 2.0 - 1.0
        z = 1.0 - abs(u) - abs(v)
        if z < 0:
            su = 1.0 if u >= 0 else -1.0
            sv = 1.0 if v >= 0 else -1.0
            u, v = (1.0 - abs(v)) * su, (1.0 - abs(u)) * sv
        n = math.sqrt(u * u + v * v + z * z)
        if n == 0:
            return (0.0, 0.0, 1.0)
        return (u / n, v / n, z / n)


class OctahedronCanonicalizedTransform:
    """Canonicalized octahedron transform (normal corrections)."""

    def __init__(self, buf: DecoderBuffer):
        self.max_quantized_value = int(np.frombuffer(buf.raw(4), "<i4")[0])
        self.center_value_wire = int(np.frombuffer(buf.raw(4), "<i4")[0])
        q = self.max_quantized_value.bit_length()
        self.tool = OctahedronToolBox(q)

    def compute_original(self, pred_s: int, pred_t: int, corr_s: int, corr_t: int):
        tb = self.tool
        c = tb.center_value
        s, t = pred_s - c, pred_t - c
        in_diamond = tb.is_in_diamond(s, t)
        if not in_diamond:
            s, t = tb.invert_diamond(s, t)
        in_bottom_left = tb.is_in_bottom_left(s, t)
        rot = tb.get_rotation_count(s, t)
        if not in_bottom_left:
            s, t = tb.rotate_point(s, t, rot)
        os, ot = tb.mod_max(s + corr_s), tb.mod_max(t + corr_t)
        if not in_bottom_left:
            os, ot = tb.rotate_point(os, ot, (4 - rot) % 4)
        if not in_diamond:
            os, ot = tb.invert_diamond(os, ot)
        return os + c, ot + c


# ---------------------------------------------------------------------------
# Prediction schemes (decode side)
# ---------------------------------------------------------------------------


def decode_difference(
    corr: np.ndarray, num_components: int, transform: WrapTransform
) -> np.ndarray:
    """pred[i] = value[i-1]; sequential, vectorizable only via scan — small
    streams here, plain loop."""
    n = len(corr) // num_components
    corr = corr.reshape(n, num_components).astype(np.int64)
    out = np.zeros_like(corr)
    prev = np.zeros(num_components, np.int64)
    for i in range(n):
        out[i] = transform.compute_original(prev, corr[i])
        prev = out[i]
    return out


def parallelogram_prediction(
    out: np.ndarray,
    p: int,
    oci: int,
    table_view,
    vertex_to_data: np.ndarray,
):
    """pred = out[next(oci)] + out[prev(oci)] - out[oci] when all three data
    ids are already decoded (< p); None otherwise. `oci` is the corner
    opposite the entry corner (the Draco parallelogram entries rule)."""
    vertex = table_view.vertex
    vo = vertex_to_data[vertex[oci]]
    vn = vertex_to_data[vertex[next_corner(oci)]]
    vp = vertex_to_data[vertex[previous_corner(oci)]]
    if 0 <= vo < p and 0 <= vn < p and 0 <= vp < p:
        return out[vn] + out[vp] - out[vo]
    return None


def decode_parallelogram(
    corr: np.ndarray,
    num_components: int,
    transform: WrapTransform,
    table_view,
    vertex_to_data: np.ndarray,
    data_to_corner: np.ndarray,
) -> np.ndarray:
    """Parallelogram prediction: pred from the face opposite the entry
    corner; falls back to delta from the previously decoded value when the
    parallelogram isn't fully decoded yet. Exact Draco rule — validated on
    the liam corpus (smooth reconstruction, zero Laplacian outliers) once
    the traversal seed order is decode-order + init faces last.
    """
    n = len(corr) // num_components
    corr = corr.reshape(n, num_components).astype(np.int64)

    from uvbench.ref import native as uvt_native

    if n > 0 and uvt_native.get_draco_lib() is not None:
        res = uvt_native.parallelogram_native(
            corr,
            num_components,
            transform.min_value,
            transform.max_value,
            table_view.opposite,
            np.asarray(table_view.vertex, np.int32),
            table_view._seam,
            vertex_to_data,
            data_to_corner,
        )
        if res is not None:
            return res

    out = np.zeros_like(corr)
    out[0] = transform.compute_original(np.zeros(num_components, np.int64), corr[0])
    for p in range(1, n):
        ci = int(data_to_corner[p])
        oci = table_view.opp(ci)
        pred = (
            parallelogram_prediction(out, p, oci, table_view, vertex_to_data)
            if oci != INVALID
            else None
        )
        if pred is None:
            pred = out[p - 1]
        out[p] = transform.compute_original(pred, corr[p])
    return out


def collect_ring_parallelograms(
    values: np.ndarray,
    p: int,
    start_corner: int,
    table_view,
    vertex_to_data: np.ndarray,
    max_par: int = 4,
) -> List[np.ndarray]:
    """Corner-ring walk shared by the encode and decode sides of
    MESH_PREDICTION_CONSTRAINED_MULTI_PARALLELOGRAM: swing left from the
    entry's mapped corner (then right from the start on hitting a
    boundary), collecting up to `max_par` full parallelogram predictions
    from already-decoded entries."""
    preds: List[np.ndarray] = []
    ci = start_corner
    first_pass = True
    while ci != INVALID:
        oci = table_view.opp(ci)
        if oci != INVALID:
            pred = parallelogram_prediction(
                values, p, oci, table_view, vertex_to_data
            )
            if pred is not None:
                preds.append(pred)
                if len(preds) == max_par:
                    break
        ci = (
            table_view.swing_left(ci)
            if first_pass
            else table_view.swing_right(ci)
        )
        if ci == start_corner:
            break
        if ci == INVALID and first_pass:
            first_pass = False
            ci = table_view.swing_right(start_corner)
    return preds


def decode_constrained_multi_parallelogram(
    corr: np.ndarray,
    num_components: int,
    buf: DecoderBuffer,
    table_view,
    vertex_to_data: np.ndarray,
    data_to_corner: np.ndarray,
) -> np.ndarray:
    """MESH_PREDICTION_CONSTRAINED_MULTI_PARALLELOGRAM (method 4).

    Prediction data (read from `buf`, which sits just past the symbol
    block): four crease-edge flag streams — one rABS-coded stream per
    context, where context = (number of available parallelograms) - 1 —
    then the wrap-transform bounds. For each value, the corner ring
    around its vertex is walked (swing left from the mapped corner, then
    right from the start on hitting a boundary) collecting up to 4 full
    parallelogram predictions; the non-crease ones are averaged
    (truncated integer division) and the wrap transform folds the
    correction. No usable parallelogram ⇒ delta from the previous value.
    Mirrors the semantics of the reference's WASM decoder for foreign
    files encoded at compression levels that select this scheme
    (the reference player's `src/lib/DRACOLoader.js:483` path; the reference's own
    settings at scripts/Encoder.py:260-267 emit plain parallelogram).
    """
    max_par = 4  # Draco kMaxNumParallelograms
    n = len(corr) // num_components
    corr = corr.reshape(n, num_components).astype(np.int64)
    num_corners = 3 * table_view.num_faces
    is_crease: List[np.ndarray] = []
    for _ in range(max_par):
        num_flags = buf.varint()
        if num_flags > num_corners:
            raise ValueError("crease flag count exceeds corner count")
        if num_flags:
            dec = RansBitDecoder(buf)
            from uvbench.ref import native as uvt_native

            bits = (
                uvt_native.rabs_decode_bits_native(
                    dec.prob_zero, dec._buf, num_flags
                )
                if uvt_native.get_draco_lib() is not None
                else None
            )
            if bits is None:
                bits = np.asarray(
                    [dec.decode_bit() for _ in range(num_flags)], np.uint8
                )
            is_crease.append(np.asarray(bits, np.uint8))
        else:
            is_crease.append(np.zeros(0, np.uint8))
    transform = WrapTransform(buf)
    flag_pos = [0] * max_par
    out = np.zeros_like(corr)
    if n == 0:
        return out
    out[0] = transform.compute_original(
        np.zeros(num_components, np.int64), corr[0]
    )
    for p in range(1, n):
        preds = collect_ring_parallelograms(
            out, p, int(data_to_corner[p]), table_view, vertex_to_data,
            max_par,
        )
        used = 0
        total = np.zeros(num_components, np.int64)
        if preds:
            ctx = len(preds) - 1
            flags = is_crease[ctx]
            for i in range(len(preds)):
                pos = flag_pos[ctx]
                flag_pos[ctx] += 1
                if pos >= len(flags):
                    raise ValueError("crease flag stream exhausted")
                if not flags[pos]:
                    used += 1
                    total += preds[i]
        if used == 0:
            pred = out[p - 1]
        else:
            pred = np.asarray(
                [tdiv(int(total[c]), used) for c in range(num_components)],
                np.int64,
            )
        out[p] = transform.compute_original(pred, corr[p])
    return out


class TexCoordsPortablePredictor:
    """Geometric UV prediction (Draco MESH_PREDICTION_TEX_COORDS_PORTABLE)."""

    def __init__(
        self,
        buf: DecoderBuffer,
        table_view,
        vertex_to_data: np.ndarray,
        pos_for_corner,  # callable corner -> int64[3] position (portable)
        *,
        pos_values: Optional[np.ndarray] = None,  # [n_pos, 3] portable ints
        pos_data_of_corner: Optional[np.ndarray] = None,  # corner -> pos idx
    ):
        self.view = table_view
        self.vertex_to_data = vertex_to_data
        self.pos_for_corner = pos_for_corner
        self._pos_values = pos_values
        self._pos_data_of_corner = pos_data_of_corner
        num_orientations = int(np.frombuffer(buf.raw(4), "<i4")[0])
        dec = RansBitDecoder(buf)
        from uvbench.ref import native as uvt_native

        bits = (
            uvt_native.rabs_decode_bits_native(
                dec.prob_zero, dec._buf, num_orientations
            )
            if uvt_native.get_draco_lib() is not None
            else None
        )
        if bits is not None:
            # delta decode: last starts True, bit 0 flips
            self.orientations = (
                (np.cumsum(bits == 0) % 2) == 0
            ).tolist()
        else:
            last = True
            self.orientations = []
            for _ in range(num_orientations):
                if not dec.decode_bit():
                    last = not last
                self.orientations.append(last)

    def decode(
        self, corr: np.ndarray, transform: WrapTransform, data_to_corner: np.ndarray
    ) -> np.ndarray:
        n = len(corr) // 2
        corr = corr.reshape(n, 2).astype(np.int64)

        from uvbench.ref import native as uvt_native

        if (
            n > 0
            and self._pos_values is not None
            and self._pos_data_of_corner is not None
            and uvt_native.get_draco_lib() is not None
        ):
            res = uvt_native.texcoords_native(
                corr,
                transform.min_value,
                transform.max_value,
                np.asarray(self.view.vertex, np.int32),
                self.vertex_to_data,
                data_to_corner,
                np.asarray(self._pos_values, np.int64),
                np.asarray(self._pos_data_of_corner, np.int32),
                np.asarray(self.orientations, np.uint8),
            )
            if res is not None:
                self.orientations = []
                return res

        out = np.zeros_like(corr)
        vertex = self.view.vertex
        v2d = self.vertex_to_data
        for p in range(n):
            ci = int(data_to_corner[p])
            nc, pc = next_corner(ci), previous_corner(ci)
            next_id = int(v2d[vertex[nc]])
            prev_id = int(v2d[vertex[pc]])
            pred = self._predict(p, ci, nc, pc, next_id, prev_id, out)
            out[p] = transform.compute_original(pred, corr[p])
        if self.orientations:
            raise ValueError(f"{len(self.orientations)} unconsumed orientations")
        return out

    def _predict(self, p, ci, nc, pc, next_id, prev_id, out):
        if 0 <= prev_id < p and 0 <= next_id < p:
            n_uv = out[next_id]
            p_uv = out[prev_id]
            if p_uv[0] == n_uv[0] and p_uv[1] == n_uv[1]:
                return p_uv.copy()
            tip_pos = self.pos_for_corner(ci)
            next_pos = self.pos_for_corner(nc)
            prev_pos = self.pos_for_corner(pc)
            pn = [int(prev_pos[k]) - int(next_pos[k]) for k in range(3)]
            pn_norm2 = pn[0] * pn[0] + pn[1] * pn[1] + pn[2] * pn[2]
            if pn_norm2 != 0:
                cn = [int(tip_pos[k]) - int(next_pos[k]) for k in range(3)]
                cn_dot_pn = sum(pn[k] * cn[k] for k in range(3))
                pn_uv = [int(p_uv[0]) - int(n_uv[0]), int(p_uv[1]) - int(n_uv[1])]
                x_uv = [
                    int(n_uv[0]) * pn_norm2 + cn_dot_pn * pn_uv[0],
                    int(n_uv[1]) * pn_norm2 + cn_dot_pn * pn_uv[1],
                ]
                x_pos = [
                    int(next_pos[k]) + tdiv(cn_dot_pn * pn[k], pn_norm2)
                    for k in range(3)
                ]
                cx = [int(tip_pos[k]) - x_pos[k] for k in range(3)]
                cx_norm2 = cx[0] * cx[0] + cx[1] * cx[1] + cx[2] * cx[2]
                pn_uv_perp = [pn_uv[1], -pn_uv[0]]
                norm_sq = math.isqrt(cx_norm2 * pn_norm2)
                orientation = True
                if self.orientations:
                    orientation = self.orientations.pop()
                if orientation:
                    pu = tdiv(x_uv[0] + pn_uv_perp[0] * norm_sq, pn_norm2)
                    pv = tdiv(x_uv[1] + pn_uv_perp[1] * norm_sq, pn_norm2)
                else:
                    pu = tdiv(x_uv[0] - pn_uv_perp[0] * norm_sq, pn_norm2)
                    pv = tdiv(x_uv[1] - pn_uv_perp[1] * norm_sq, pn_norm2)
                return np.array([pu, pv], np.int64)
        # fallback
        if 0 <= prev_id < p:
            return out[prev_id].copy()
        if 0 <= next_id < p:
            return out[next_id].copy()
        return out[p - 1].copy() if p > 0 else np.zeros(2, np.int64)


class GeometricNormalPredictor:
    """Area-weighted geometric normal prediction over the position fan."""

    MODE_ONE_TRIANGLE = 0
    MODE_TRIANGLE_AREA = 1

    def __init__(
        self,
        buf: DecoderBuffer,
        full_table: CornerTable,
        pos_for_corner,
        *,
        pos_values: Optional[np.ndarray] = None,
        pos_data_of_corner: Optional[np.ndarray] = None,
    ):
        self.transform = OctahedronCanonicalizedTransform(buf)
        # bitstream >= 2.2 has no prediction-mode byte: TRIANGLE_AREA fixed
        self.mode = self.MODE_TRIANGLE_AREA
        self.flip_decoder = RansBitDecoder(buf)
        self.ct = full_table
        self.pos_for_corner = pos_for_corner
        self._pos_values = pos_values
        self._pos_data_of_corner = pos_data_of_corner

    def _face_normal(self, corner: int):
        c = self.pos_for_corner(corner)
        nn = self.pos_for_corner(next_corner(corner))
        pp = self.pos_for_corner(previous_corner(corner))
        d1 = [int(nn[k]) - int(c[k]) for k in range(3)]
        d2 = [int(pp[k]) - int(c[k]) for k in range(3)]
        return [
            d1[1] * d2[2] - d1[2] * d2[1],
            d1[2] * d2[0] - d1[0] * d2[2],
            d1[0] * d2[1] - d1[1] * d2[0],
        ]

    def predict(self, corner: int):
        """Accumulate cross products around the corner's (position) vertex."""
        ct = self.ct
        normal = [0, 0, 0]
        start = corner
        c = corner
        while c != INVALID:
            fn = self._face_normal(c)
            normal = [normal[k] + fn[k] for k in range(3)]
            if self.mode == self.MODE_ONE_TRIANGLE:
                break
            c = ct.swing_right(c)
            if c == start:
                return normal
        if self.mode == self.MODE_TRIANGLE_AREA and c == INVALID:
            c = ct.swing_left(start)
            while c != INVALID and c != start:
                fn = self._face_normal(c)
                normal = [normal[k] + fn[k] for k in range(3)]
                c = ct.swing_left(c)
        return normal

    def decode(self, corr: np.ndarray, data_to_corner: np.ndarray) -> np.ndarray:
        n = len(corr) // 2
        corr = corr.reshape(n, 2).astype(np.int64)

        from uvbench.ref import native as uvt_native

        if (
            n > 0
            and self._pos_values is not None
            and self._pos_data_of_corner is not None
            and uvt_native.get_draco_lib() is not None
        ):
            view = self.ct
            res = uvt_native.normals_native(
                corr,
                self.transform.max_quantized_value,
                self.transform.center_value_wire,
                np.asarray(view.opposite, np.int32),
                np.asarray(view.vertex, np.int32),
                getattr(view, "_seam", None),
                data_to_corner,
                np.asarray(self._pos_values, np.int64),
                np.asarray(self._pos_data_of_corner, np.int32),
                self.flip_decoder.prob_zero,
                self.flip_decoder._buf,
            )
            if res is not None:
                return res

        out = np.zeros_like(corr)
        tb = self.transform.tool
        for p in range(n):
            ci = int(data_to_corner[p])
            normal = self.predict(ci)
            normal = tb.canonicalize_integer_vector(normal)
            if self.flip_decoder.decode_bit():
                normal = [-x for x in normal]
            ps, pt = tb.integer_vector_to_quantized_octahedral_coords(normal)
            out[p] = self.transform.compute_original(
                ps, pt, int(corr[p, 0]), int(corr[p, 1])
            )
        return out
