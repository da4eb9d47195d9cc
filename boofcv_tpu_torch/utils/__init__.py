"""Host-side support utilities (port of ``boofcv_tpu/utils``)."""
