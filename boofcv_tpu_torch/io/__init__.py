"""I/O and simulation (port of boofcv_tpu.io): image files (PNM, PNG),
calibration YAML, PLY point clouds, MJPEG and image sequences, debug
plots, the BAL codec, checkpoints and synthetic-world rendering."""
