"""Host input of the port: mesh files (`meshio`), PNG images (`image`) and
audio durations (`audio`), copies of the reference's but for the PNG
reader, which replaces its Pillow call."""
