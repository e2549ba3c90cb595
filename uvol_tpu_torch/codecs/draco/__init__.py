"""Draco: the constants the port's `.drc` paths use (the frame codec itself
is the native library of `uvol_tpu_torch/native`)."""
