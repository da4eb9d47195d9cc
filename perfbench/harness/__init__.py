"""The benchmark harness of boofcv_tpu_torch (see ``perfbench/run.py``)."""
