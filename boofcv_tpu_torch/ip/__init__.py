"""Image processing (port of boofcv_tpu.ip)."""
