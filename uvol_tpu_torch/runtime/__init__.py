"""Host -> device streaming of the port (`device_stream`)."""
