"""QR code encode/decode (port of ``boofcv_tpu/recognition/qr``).

Reference analog: boofcv-recognition alg/fiducial/qrcode/ —
QrCode.java (spec tables), QrCodeEncoder/QrCodeGenerator,
QrCodeDecoderBits/QrCodeDecoderImage, ReidSolomonCodes.java,
GaliosFieldTableOps.java, QrCodeMaskPattern, position pattern detection.
The codec is host Python and numpy (integer Galois arithmetic), as in the
reference; only the detector's threshold and homographies touch the device.
"""

from boofcv_tpu_torch.recognition.qr.galois import GF256  # noqa: F401
from boofcv_tpu_torch.recognition.qr.reed_solomon import ReedSolomon  # noqa: F401
