"""Draco bitstream constants (v2.2) — the port's copy of
`uvol_tpu/codecs/draco/constants.py`, cut to what it uses: the attribute
types and the data types of `native.drc_encode_native` and
`models/drc_device.py`."""

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
