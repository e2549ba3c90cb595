"""Draco: the constants the port's `.drc` paths use and the player's frame
decoder (`decoder.decode_drc`); the frame codec itself is the native
library of `uvol_tpu_torch/native`."""
