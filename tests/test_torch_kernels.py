"""The CUDA kernel against its plain PyTorch version on the card. A CUDA
kernel has no CPU mode, so every test here needs a device and skips
without one. On a GPU machine (no jax needed):

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from zignal_tpu_torch import ImageBatch
from zignal_tpu_torch.ops import fused_pipeline as fp
from zignal_tpu_torch.ops.interpolation import resize

pytestmark = pytest.mark.cuda

OKLAB_TOL = 5e-6

CASES = [  # (shape, out_rows, out_cols, sigma): test_pallas_pipeline's
    ((2, 256, 256, 3), 128, 128, 2.0),
    ((1, 384, 512, 3), 192, 256, 2.0),
    ((1, 500, 400, 3), 128, 128, 2.0),
    ((1, 192, 256, 3), 128, 128, 0.5),
    ((1, 192, 256, 3), 128, 128, 1.0),
    ((1, 192, 256, 3), 128, 128, 3.5),
    ((1, 1080, 960, 3), 360, 640, 1.5),
    ((1, 300, 512, 3), 150, 300, 1.5),
    ((2, 256, 256, 4), 100, 100, 1.5),
    ((2, 256, 256, 1), 100, 190, 1.5),
    ((1, 256, 256, 3), 320, 288, 1.5),
    ((2, 300, 400, 3), 128, 128, 0.0),
    ((1, 37, 53, 3), 100, 9, 3.5),
    ((2, 1, 64, 3), 3, 32, 1.0),
    ((2, 64, 1, 4), 31, 1, 2.0),
    ((1, 64, 64, 3), 40, 40, 30.0),   # radius 90: > 48 KB shared memory
    ((1, 64, 64, 4), 40, 40, 30.0),   # radius 90, RGBA: a 16-px tile
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _u8(shape, seed, device):
    x = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("shape,oh,ow,sigma", CASES)
def test_kernel_u8_equals_plain(cuda, shape, oh, ow, sigma):
    x = _u8(shape, 0, cuda)
    before = fp.LAUNCHES
    got = fp.fused_resize_blur_oklab(x, oh, ow, sigma, oklab=False)
    want = fp.fused_resize_blur_oklab_reference(x, oh, ow, sigma,
                                                oklab=False)
    torch.cuda.synchronize()
    assert fp.LAUNCHES == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,oh,ow,sigma",
                         [c for c in CASES if c[0][-1] == 3])
def test_kernel_oklab_within_bound_of_plain(cuda, shape, oh, ow, sigma):
    x = _u8(shape, 1, cuda)
    got = fp.fused_resize_blur_oklab(x, oh, ow, sigma)
    want = fp.fused_resize_blur_oklab_reference(x, oh, ow, sigma)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= OKLAB_TOL


def test_image_batch_main_path_launches_the_kernel(cuda):
    x = _u8((2, 256, 256, 3), 2, cuda)
    ib = ImageBatch(x, device=cuda)
    before = fp.LAUNCHES
    lab = ib.resize_blur_oklab((128, 128), 2.0)
    small = ib.resize((128, 128))
    assert fp.LAUNCHES == before + 2
    want = fp.fused_resize_blur_oklab_reference(x, 128, 128, 2.0)
    assert float((lab - want).abs().max()) <= OKLAB_TOL
    assert torch.equal(small.device_array(),
                       fp.fused_resize_blur_oklab_reference(
                           x, 128, 128, 0.0, oklab=False))


def test_resize_of_one_image_on_the_card(cuda):
    x = _u8((1, 70, 90, 4), 3, cuda)
    assert torch.equal(resize(x[0], 33, 47), resize(x.cpu(), 33, 47)[0].to(cuda))


def test_kernel_rejects_non_contiguous(cuda):
    x = _u8((1, 64, 64, 3), 4, cuda)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fp.fused_resize_blur_oklab(x, 16, 16, 1.0)
