# Frozen copy of the program's `codecs/draco/constants.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""Draco bitstream constants (v2.2), as consumed by the reference via

The port's copy of `uvol_tpu/codecs/draco/constants.py`, unchanged in what it emits; it
calls the port's own native library (`uvbench.ref.native`).

draco_decoder.wasm (src/V2/player.ts:101, src/lib/DRACOLoader.js:483).

Values reverse-engineered/validated against the liam corpus
(`example/public/liam/output/geometry_draco/*.drc`).
"""

MAGIC = b"DRACO"

# encoder_type
POINT_CLOUD = 0
TRIANGULAR_MESH = 1

# encoder_method
MESH_SEQUENTIAL_ENCODING = 0
MESH_EDGEBREAKER_ENCODING = 1

METADATA_FLAG_MASK = 0x8000

# edgebreaker traversal coder
MESH_EDGEBREAKER_STANDARD_ENCODING = 0
MESH_EDGEBREAKER_PREDICTIVE_ENCODING = 1
MESH_EDGEBREAKER_VALENCE_ENCODING = 2

# CLER topology symbols (bit patterns of the standard coder)
TOPOLOGY_C = 0x0
TOPOLOGY_S = 0x1
TOPOLOGY_L = 0x3
TOPOLOGY_R = 0x5
TOPOLOGY_E = 0x7

#: valence-context symbol index → topology symbol (validated on liam:
#: per-context counts of index 1 sum to exactly num_encoded_split_symbols)
SYMBOL_TO_TOPOLOGY = (TOPOLOGY_C, TOPOLOGY_S, TOPOLOGY_L, TOPOLOGY_R, TOPOLOGY_E)

MIN_VALENCE = 2
MAX_VALENCE = 7
NUM_VALENCE_CONTEXTS = MAX_VALENCE - MIN_VALENCE + 1

LEFT_FACE_EDGE = 0
RIGHT_FACE_EDGE = 1

# attribute decoder types
MESH_VERTEX_ATTRIBUTE = 0
MESH_CORNER_ATTRIBUTE = 1

# traversal methods
MESH_TRAVERSAL_DEPTH_FIRST = 0
MESH_TRAVERSAL_PREDICTION_DEGREE = 1

# GeometryAttribute::Type
ATT_POSITION = 0
ATT_NORMAL = 1
ATT_COLOR = 2
ATT_TEX_COORD = 3
ATT_GENERIC = 4

# data types
DT_INT8 = 1
DT_UINT8 = 2
DT_INT16 = 3
DT_UINT16 = 4
DT_INT32 = 5
DT_UINT32 = 6
DT_INT64 = 7
DT_UINT64 = 8
DT_FLOAT32 = 9
DT_FLOAT64 = 10
DT_BOOL = 11

DATA_TYPE_SIZE = {
    DT_INT8: 1, DT_UINT8: 1, DT_INT16: 2, DT_UINT16: 2,
    DT_INT32: 4, DT_UINT32: 4, DT_INT64: 8, DT_UINT64: 8,
    DT_FLOAT32: 4, DT_FLOAT64: 8, DT_BOOL: 1,
}

# sequential attribute encoder types
SEQ_GENERIC = 0
SEQ_INTEGER = 1
SEQ_QUANTIZATION = 2
SEQ_NORMALS = 3

# prediction scheme methods
PREDICTION_NONE = -2
PREDICTION_UNDEFINED = -1
PREDICTION_DIFFERENCE = 0
MESH_PREDICTION_PARALLELOGRAM = 1
MESH_PREDICTION_MULTI_PARALLELOGRAM = 2
MESH_PREDICTION_TEX_COORDS_DEPRECATED = 3
MESH_PREDICTION_CONSTRAINED_MULTI_PARALLELOGRAM = 4
MESH_PREDICTION_TEX_COORDS_PORTABLE = 5
MESH_PREDICTION_GEOMETRIC_NORMAL = 6

# prediction scheme transforms
PREDICTION_TRANSFORM_DELTA = 0
PREDICTION_TRANSFORM_WRAP = 1
PREDICTION_TRANSFORM_NORMAL_OCTAHEDRON = 2
PREDICTION_TRANSFORM_NORMAL_OCTAHEDRON_CANONICALIZED = 3

INVALID = -1
