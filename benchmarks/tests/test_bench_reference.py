"""The frozen references held to the port's plain path at small sizes
(u8 equal, Oklab within the port's own 5e-6), the roofline copy to its
values, and the import rules of the benchmark's modules."""

import ast
from pathlib import Path

import pytest
import torch

from benchmarks import roofline
from benchmarks.reference import common, filter_fusion, north_star

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmarks"
OKLAB_TOL = 5e-6


def _u8(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0, 3.3])
def test_gaussian_taps(sigma):
    from zignal_tpu_torch.ops.tables import _kernel_to_int, gaussian_kernel

    assert (common.gaussian_taps(sigma)
            == _kernel_to_int(gaussian_kernel(sigma))).all()


@pytest.mark.parametrize("b,h,w,rows,cols,sigma", [
    (2, 64, 48, 32, 20, 2.0), (1, 37, 53, 71, 19, 1.5),
    (2, 100, 100, 50, 50, 2.0), (1, 9, 7, 3, 2, 2.0), (1, 20, 30, 40, 60, 0.0),
])
def test_north_star_matches_the_plain_path(b, h, w, rows, cols, sigma):
    from zignal_tpu_torch.ops.fused_pipeline import \
        fused_resize_blur_oklab_reference as plain

    x = _u8((b, h, w, 3), b * h + w)
    ref_u8 = common.blur_u8(north_star.resize_u8(x, rows, cols), sigma)
    assert torch.equal(ref_u8, plain(x, rows, cols, sigma, oklab=False))
    gap = (plain(x, rows, cols, sigma).double()
           - north_star.north_star(x, rows, cols, sigma)).abs().max()
    assert gap <= OKLAB_TOL


@pytest.mark.parametrize("shape,sigma,radius,thr", [
    ((2, 64, 48), 2.0, 2, 128.0), ((1, 37, 53), 1.5, 3, 127.5),
    ((40, 40), 2.0, 2, 100.0), ((3, 5, 6), 2.0, 2, 128.0),
    ((30, 30), 0.0, 0, 128.0), ((1, 450, 450), 1.0, 200, 128.0),
])
def test_filter_matches_the_plain_path(shape, sigma, radius, thr):
    from zignal_tpu_torch.ops.filter_chain import \
        fused_blur_sharpen_morph_reference as plain

    x = _u8(shape, sum(shape))
    assert torch.equal(filter_fusion.filter_chain(x, sigma, radius, thr),
                       plain(x, sigma, radius, thr))


def test_integer_sharpen_form_is_reached():
    assert filter_fusion.sums_fit_f32(1024, 1024, 2)
    assert not filter_fusion.sums_fit_f32(450, 450, 200)


def test_roofline_copy():
    ms, which = roofline.k1_bound(16, 1024, 512)
    assert which == "bytes" and round(ms, 5) == 0.03005
    ms, which = roofline.k2_bound(16, 1024)
    assert which == "operations" and round(ms, 5) == 0.01778


def test_roofline_copy_equals_the_program_today():
    from zignal_tpu_torch import _bounds

    assert roofline.k1_bound(16, 1024, 512) == _bounds.k1_bound(16, 1024, 512)
    assert roofline.k2_bound(1, 1024) == _bounds.k2_bound(1, 1024)


def _imports(path: Path) -> set:
    """Every module ``path`` imports, by its full dotted name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
# the program's own measurement, which the benchmark replaces
PROGRAM_YARDSTICK = ("zignal_tpu_torch.bench", "zignal_tpu_torch._bounds",
                     "zignal_tpu_torch.profiling")


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_imports(path):
    names = _imports(path)
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"jax", "jaxlib", "flax", "zignal_tpu"}
    if "reference" in path.parts:
        assert "zignal_tpu_torch" not in tops
    assert not any(n == m or n.startswith(m + ".")
                   for n in names for m in PROGRAM_YARDSTICK)
    text = path.read_text()
    assert "bench.py" not in text and "BENCH_" not in text
