"""Feature detection, tracking and stereo matching (port of boofcv_tpu.feature)."""
