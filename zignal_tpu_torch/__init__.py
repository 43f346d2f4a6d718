"""zignal-tpu's PyTorch/CUDA port: the Image container and ImageBatch, the
colour classes, Histogram, Rectangle and the blend modes, the PNG, JPEG
and BMP codecs with their native host library, the pinned-memory file
loader, the resize -> blur -> Oklab batch path, the config-3 filter chain
and the windowed filters, the config-2 colour chain with the
colour-conversion graph, the histogram ops, every resize method, the
convolutions, the order-statistic blurs, the edge detectors, the image
pyramid, the geometric transforms and warps (rotate, crop, extract,
insert, warp), motion blur, the image-quality metrics, Feature
Distribution Matching, PCA and Matrix, the features (FAST, ORB, the
Hamming matcher, the tracer), the Hough transform, and Canvas with the
bitmap fonts.

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
from .enums import BorderMode, DrawMode, Interpolation
from .fdm import FeatureDistributionMatching
from .font import BitmapFont
from .geometry import (AffineTransform, ConvexHull, ProjectiveTransform,
                       SimilarityTransform)
from .histogram import Histogram
from .image import Image, PixelIterator
from .io_pipeline import BatchLoader, load_image_batch
from .matrix import Matrix
from .motion_blur import MotionBlur
from .pca import PCA
from .rectangle import Rectangle
from .stats import RunningStats

__all__ = [
    "Image", "PixelIterator", "ImageBatch", "BatchLoader",
    "load_image_batch", "Histogram", "Rectangle", "Blending",
    "Interpolation", "BorderMode", "SimilarityTransform", "AffineTransform",
    "ProjectiveTransform", "ConvexHull", "MotionBlur", "RunningStats",
    "FeatureDistributionMatching", "PCA", "Matrix", "Canvas", "BitmapFont",
    "DrawMode",
    "Gray", "Rgb", "Rgba", "Hsl", "Hsv", "Lab", "Lch", "Lms", "Oklab",
    "Oklch", "Xyb", "Xyz", "Ycbcr", "__version__",
]
