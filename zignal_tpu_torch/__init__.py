"""zignal-tpu's PyTorch/CUDA port: the Image container and ImageBatch, the
colour classes, Histogram, Rectangle and the blend modes, the PNG, JPEG,
BMP and GIF codecs with their native host library (and the quantize and
dither ops under GIF and sixel), the pinned-memory file loader, the
resize -> blur -> Oklab batch path, the config-3 filter chain
and the windowed filters, the config-2 colour chain with the
colour-conversion graph, the histogram ops, every resize method, the
convolutions, the order-statistic blurs, the edge detectors, the image
pyramid, the geometric transforms and warps (rotate, crop, extract,
insert, warp), motion blur, the image-quality metrics, Feature
Distribution Matching, PCA and Matrix, the features (FAST, ORB, the
Hamming matcher, the tracer), the Hough transform, Canvas with the
bitmap fonts, the colormaps, flood fill, Perlin noise, QR encode and
decode, the terminal renderings (sixel, kitty, iTerm2, SGR, braille), the
global optimizer and the assignment solver, and the ``zignal-torch`` CLI
(``python -m zignal_tpu_torch.cli``, on the card unless ``--device cpu``).

Imports torch and numpy only (never jax, never ``zignal_tpu``). Every
entry that places data takes an explicit ``device=``; functions on
tensors run on their input's device. On a CUDA tensor each ported TPU
kernel is a hand-written kernel (csrc/), built with nvcc at first use; on
a CPU tensor it is the plain PyTorch version of the same arithmetic.
"""

__version__ = "0.1.0"

from .batch import ImageBatch
from .blending import Blending
from .canvas import Canvas
from .color._classes import (Gray, Hsl, Hsv, Lab, Lch, Lms, Oklab, Oklch,
                             Rgb, Rgba, Xyb, Xyz, Ycbcr)
from .codecs.gif import AnimatedImage
from .colormaps import Colormap
from .enums import BorderMode, DrawMode, Interpolation, ThresholdMode
from .fdm import FeatureDistributionMatching
from .font import BitmapFont
from .geometry import (AffineTransform, ConvexHull, ProjectiveTransform,
                       SimilarityTransform)
from .histogram import Histogram
from .image import Image, PixelIterator
from .io_pipeline import BatchLoader, load_image_batch
from .matrix import Matrix
from .motion_blur import MotionBlur
from .optimization import (Assignment, GlobalOptimizer, OptimizationPolicy,
                           optimize, solve_assignment_problem)
from .pca import PCA
from .perlin import perlin, perlin_array
from .qrcode import EcLevel, QrDecodeResult
from .rectangle import Rectangle
from .stats import RunningStats


def qrcode_encode(data, ec_level=None, version=None, module_size: int = 8,
                  quiet_zone: int = 4, *, device):
    """Encode str/bytes as a QR code -> grayscale Image on ``device``
    (reference: bindings qrcode.zig:287 qrcode_encode)."""
    from .qrcode import encode_text

    level = EcLevel.MEDIUM if ec_level is None else EcLevel(ec_level)
    return encode_text(data, level, version, module_size, quiet_zone,
                       device=device)


def qrcode_decode(image):
    """Decode the first QR code in an Image -> QrDecodeResult or None,
    binarized on the image's device
    (reference: bindings qrcode.zig qrcode_decode)."""
    from .qrcode import decode_image

    if not isinstance(image, Image):
        raise TypeError("qrcode_decode expects an Image")
    results = decode_image(image)
    return results[0] if results else None


__all__ = [
    "Image", "PixelIterator", "ImageBatch", "BatchLoader",
    "load_image_batch", "Histogram", "Rectangle", "Blending",
    "Interpolation", "BorderMode", "ThresholdMode", "SimilarityTransform",
    "AffineTransform", "ProjectiveTransform", "ConvexHull", "MotionBlur",
    "RunningStats", "FeatureDistributionMatching", "PCA", "Matrix", "Canvas",
    "BitmapFont", "DrawMode", "Colormap", "AnimatedImage", "perlin",
    "perlin_array", "EcLevel", "QrDecodeResult", "qrcode_encode",
    "qrcode_decode", "OptimizationPolicy", "Assignment",
    "solve_assignment_problem", "optimize", "GlobalOptimizer",
    "Gray", "Rgb", "Rgba", "Hsl", "Hsv", "Lab", "Lch", "Lms", "Oklab",
    "Oklch", "Xyb", "Xyz", "Ycbcr", "__version__",
]
