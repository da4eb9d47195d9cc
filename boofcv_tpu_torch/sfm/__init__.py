"""Structure from motion: stereo visual odometry (port of boofcv_tpu.sfm)."""
