"""Distributed execution on ``torch.distributed``: meshes, point-sharded
bundle adjustment, sharded RANSAC and pair matching (port of
``boofcv_tpu/dist/``).

No reference analog: BoofCV's only parallelism is a single-JVM ForkJoinPool
(boofcv-types concurrency/BoofConcurrency.java:35).  One process a rank,
``DeviceMesh`` groups, NCCL on the card and gloo on the CPU.
"""

from boofcv_tpu_torch.dist.mesh import make_mesh, device_count  # noqa: F401
