"""Geometry: SE(3), P3P, RANSAC (port of boofcv_tpu.geo)."""
