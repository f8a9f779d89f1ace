"""Host-side utilities of the port: logging, chunked checkpointing, profiling."""
