"""Command-line applications (port of ``boofcv_tpu/cli``).

Reference analog: applications/ (CameraCalibration.java,
BatchScanQrCodes.java, CreateFiducialSquareImage, ...) and examples/ —
thin argparse commands over the library.  Each keeps the JAX command's
flags and file formats and adds ``--device cpu|cuda``: the default is the
card, and without one a command raises.  Run as::

    python -m boofcv_tpu_torch.cli.<tool> [--device cpu|cuda] ...
"""
