"""Draco: the port's copy of the reference's `.drc` codec (the staged
Python decoder and encoder, with their native helpers and whole-frame
fast paths in `uvol_tpu_torch.native`) and the synthetic grids the smoke
and tests encode (`grid.py`)."""
