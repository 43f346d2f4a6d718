"""QR code encode/decode (reference: src/qrcode/)."""

from .decoder import QrDecodeResult, decode_image
from .encoder import QrEncodeError, encode_text, encode_to_matrix
from .tables import EcLevel

__all__ = ["EcLevel", "encode_text", "encode_to_matrix", "decode_image",
           "QrDecodeResult", "QrEncodeError"]
