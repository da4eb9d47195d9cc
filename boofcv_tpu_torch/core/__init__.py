"""Image containers and border rules (port of boofcv_tpu.core)."""
