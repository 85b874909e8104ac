"""jaxjpeg: a JPEG decode engine for accelerators (JAX / XLA / Pallas).

A from-scratch reimagining of negge/jpeg_gpu in JAX: baseline (SOF0) 8-bit
JPEG decode in which entropy decode produces dense quantized DCT
coefficient tensors, and the device performs dequantization, the 8x8
inverse DCT, chroma upsampling and YCbCr->RGB conversion.

Like the reference (jpeg_wrap.h:24-31), the pipeline cut point is an explicit
API axis -- ``pack | quant | dct | yuv | rgb`` -- and multiple backends sit
behind one decoder interface for differential testing.
"""

from jaxjpeg.errors import JpegError, JpegFormatError, JpegUnsupportedError
from jaxjpeg.info import (
    JpegHeader,
    Component,
    QuantTable,
    HuffmanSpec,
    ScanHeader,
    Subsampling,
)
from jaxjpeg.engine.stages import OutputStage
from jaxjpeg.engine.decoder import (
    Decoder,
    HostDecoder,
    DeviceDecoder,
    PilDecoder,
    get_decoder,
    decode,
    decode_header,
)

__version__ = "0.1.0"

__all__ = [
    "JpegError",
    "JpegFormatError",
    "JpegUnsupportedError",
    "JpegHeader",
    "Component",
    "QuantTable",
    "HuffmanSpec",
    "ScanHeader",
    "Subsampling",
    "OutputStage",
    "Decoder",
    "HostDecoder",
    "DeviceDecoder",
    "PilDecoder",
    "get_decoder",
    "decode",
    "decode_header",
]
