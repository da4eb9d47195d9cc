"""Synthetic data for tests and the chip smoke run (port of boofcv_tpu.io)."""
