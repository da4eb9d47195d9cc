"""Camera calibration, Zhang99 planar (port of boofcv_tpu.calib)."""
