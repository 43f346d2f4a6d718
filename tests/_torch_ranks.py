"""Gloo CPU ranks for the port's mesh tests. Imports torch and numpy only
(never jax), so that each spawned rank starts quickly.

``run_ranks(world, body, tmp_path)`` spawns ``world`` processes that join
one gloo process group through a ``file://`` rendezvous under
``tmp_path`` (no port to collide on between test workers), run the named
body of ``BODIES`` with one thread each, and return every rank's dict of
results (numpy arrays, numbers, strings). A body computes every case of a
test module at once, so a module spawns once per world size; each case
stays its own test.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

BORDERS = ("zero", "replicate", "mirror", "wrap")


def arr(b=8, h=32, w=48, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, c),
                                                dtype=np.uint8)


def pad_rows(img: np.ndarray, radius: int, border: str) -> np.ndarray:
    """``img`` padded by ``radius`` rows in a border mode, in numpy."""
    mode = {"zero": "constant", "replicate": "edge", "mirror": "reflect",
            "wrap": "wrap"}[border]
    widths = [(radius, radius)] + [(0, 0)] * (img.ndim - 1)
    return np.pad(img, widths, mode=mode)


# -- the parallel/ cases (tests/test_torch_parallel.py) ----------------------

SPATIAL = dict(h=16, w=24, c=3)  # rows of one rank's shard


def parallel_inputs(world: int):
    rng = np.random.default_rng(11)
    h = SPATIAL["h"] * world
    img = rng.integers(0, 256, (h, SPATIAL["w"], SPATIAL["c"]), np.uint8)
    other = np.clip(img.astype(np.int32) + rng.integers(-20, 20, img.shape),
                    0, 255).astype(np.uint8)
    return dict(
        img=img, other=other,
        plane=rng.integers(0, 256, (h, 28), np.uint8),
        fplane=(rng.random((h, 24), dtype=np.float32) * 255.0),
        mask=((rng.random((h, 24)) > 0.85).astype(np.uint8) * 255),
        batch=rng.integers(0, 256, (2 * world, 24, 24, 3), np.uint8),
        target=rng.integers(30, 220, (20, 20, 3), np.uint8),
        equalize=rng.integers(10, 200, (h, 24, 3), np.uint8),
        batch2d=rng.integers(0, 256, (4, 32, 16, 3), np.uint8),
        planes2d=rng.random((4, 32, 16)).astype(np.float32),
    )


def _counted(record, name, fn):
    from zignal_tpu_torch.parallel import _comm

    before = dict(_comm.COLLECTIVES)
    out = fn()
    record[name + "/counts"] = {k: _comm.COLLECTIVES[k] - before[k]
                                for k in before}
    return out


def _np(x):
    from zignal_tpu_torch.parallel import _comm

    if hasattr(x, "full_tensor"):
        x = _comm.full(x)
    return x.cpu().numpy()


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def parallel_body(world: int) -> dict:
    from functools import partial

    import zignal_tpu_torch.parallel as P
    from zignal_tpu_torch import FeatureDistributionMatching, Image
    from zignal_tpu_torch.enums import BorderMode
    from zignal_tpu_torch.ops.convolution import gaussian_blur
    from zignal_tpu_torch.ops.order_stat import median_blur
    from zignal_tpu_torch.ops.convolution import sobel_magnitude
    from zignal_tpu_torch.parallel import _comm

    P.init_distributed(device="cpu")  # already joined: does nothing
    mesh = P.make_mesh(world, device="cpu")
    x = parallel_inputs(world)
    out = {}
    img, h = x["img"], x["img"].shape[0]
    local = _comm.local_shard(img, mesh, {"batch": 0})
    for name in BORDERS:
        border = BorderMode[name.upper()]
        for radius in (1, 3, SPATIAL["h"] - 1):
            ext = _counted(out, f"halo/{name}/{radius}", lambda: P.halo_extend(
                local, radius, border, mesh))
            out[f"halo/{name}/{radius}"] = _comm.all_gather(
                ext[None], mesh, "batch", 0).numpy()
        out[f"gauss/{name}"] = _np(_counted(
            out, f"gauss/{name}",
            lambda: P.spatial_gaussian_blur(mesh, 1.2, border)(img)))
        out[f"op/{name}"] = _np(P.spatial_op(
            mesh, lambda t: gaussian_blur(t, 1.2, border), 4, border)(img))
    out["gauss/f32"] = _np(P.spatial_gaussian_blur(mesh, 1.5)(
        img.astype(np.float32)))
    out["gauss/sigma0_is_input"] = P.spatial_gaussian_blur(mesh, 0.0)(img) \
        is img
    for radius in (1, 3):
        out[f"box/{radius}"] = _np(_counted(
            out, f"box/{radius}",
            lambda: P.spatial_box_blur(mesh, h, radius)(img)))
    out["sharpen"] = _np(P.spatial_sharpen(mesh, h, 2)(img))
    out["adaptive"] = _np(P.spatial_adaptive_mean_threshold(
        mesh, h, 3, 5.0)(x["plane"]))
    out["sobel"] = _np(P.spatial_sobel(mesh)(x["fplane"]))
    for k, it in ((3, 1), (3, 2), (5, 1)):
        out[f"dilate/{k}/{it}"] = _np(P.spatial_dilate(mesh, k, it)(x["mask"]))
        out[f"erode/{k}/{it}"] = _np(P.spatial_erode(mesh, k, it)(x["mask"]))
    out["median"] = _np(P.spatial_median_blur(mesh, 2)(img))
    out["ssim"] = float(_counted(out, "ssim", lambda: P.spatial_ssim(
        mesh, h)(img, x["other"])))
    mean, cov = P.spatial_mean_cov_image(mesh)(img)
    out["mean_cov_image"] = (mean.numpy(), cov.numpy())
    out["histogram"] = _counted(out, "histogram",
                                lambda: P.spatial_histogram(mesh)(img)).numpy()
    out["equalize"] = _np(P.spatial_equalize(mesh)(x["equalize"]))
    rgba = np.concatenate([x["equalize"], x["equalize"][..., :1]], axis=-1)
    out["equalize/rgba"] = _np(P.spatial_equalize(mesh)(rgba))
    sharded = P.shard_batch(x["batch"], mesh)
    out["shard_batch"] = (_np(sharded), tuple(sharded.to_local().shape))
    out["replicate"] = P.replicate(x["batch"], mesh).to_local().numpy()
    out["pipeline"] = _np(_counted(out, "pipeline", lambda: P.sharded_pipeline(
        mesh, 12, 12, sigma=1.0)(sharded)))
    mean, cov = _counted(out, "global_mean_cov",
                         lambda: P.global_mean_cov(mesh)(sharded))
    out["global_mean_cov"] = (mean.numpy(), cov.numpy())
    out["global_mesh"] = tuple(P.make_global_mesh(device="cpu").shape)
    fdm = FeatureDistributionMatching()
    out["match_sharded"] = _np(fdm.match_sharded(
        img, Image.from_numpy(x["target"].copy(), device="cpu"), mesh))
    # the error cases
    out["err/small_shard"] = _error(
        lambda: P.spatial_gaussian_blur(mesh, 8.0)(img))
    out["err/small_halo"] = _error(lambda: P.spatial_median_blur(
        mesh, SPATIAL["h"])(img))
    out["err/batch"] = _error(lambda: P.shard_batch(x["batch"][:2 * world - 1]
                                                    if world > 1 else
                                                    x["batch"][:0], mesh))
    out["err/rows"] = _error(lambda: P.spatial_box_blur(mesh, h - 1, 1)(
        img[:h - 1]))
    out["err/bigger_mesh"] = _error(lambda: P.make_mesh(2 * world,
                                                         device="cpu"))
    if world == 4:
        mesh2 = P.make_mesh((2, 2), ("batch", "space"), device="cpu")
        out["op2d/median"] = _np(_counted(out, "op2d/median", lambda: P.spatial_op_2d(
            mesh2, partial(median_blur, radius=2), 2)(x["batch2d"])))
        out["op2d/sobel"] = _np(P.spatial_op_2d(
            mesh2, sobel_magnitude, 1, BorderMode.REPLICATE)(x["planes2d"]))
    return out


# -- the ImageBatch cases (tests/test_torch_batch_mesh.py) -------------------

# one entry per op, applied by name: the sweep of tests/test_image_batch.py
SWEEP_OPS = [
    ("resize", ((16, 24),)),
    ("resize", (0.5, "BICUBIC")),
    ("letterbox", (24,)),
    ("rotate", (0.3,)),
    ("invert", ()),
    ("fill", ((10, 200, 30),)),
    ("set_border", ((4, 4, 40, 24), (255, 0, 0))),
    ("flip_left_right", ()),
    ("flip_top_bottom", ()),
    ("gaussian_blur", (1.5,)),
    ("box_blur", (2,)),
    ("sharpen", (1,)),
    ("median_blur", (1,)),
    ("percentile_blur", (1, 0.25)),
    ("min_blur", (1,)),
    ("max_blur", (1,)),
    ("midpoint_blur", (1,)),
    ("alpha_trimmed_mean_blur", (1, 0.2)),
    ("convolve", (((0.0, -1.0, 0.0), (-1.0, 5.0, -1.0), (0.0, -1.0, 0.0)),)),
    ("convolve_separable", ((0.25, 0.5, 0.25), (0.25, 0.5, 0.25))),
    ("sobel", ()),
    ("canny", (1.0, 40, 120)),
    ("equalize", ()),
    ("autocontrast", (0.01,)),
    ("threshold_adaptive_mean", (3, 5.0)),
    ("dilate_binary", (3, 1)),
    ("dilate_binary", (3, 2)),
    ("erode_binary", (3, 2)),
    ("open_binary", (3, 1)),
    ("close_binary", (3, 1)),
]
# ops that keep the image grid: legal on a (batch, space) mesh
SPACE_OPS = [op for op in SWEEP_OPS
             if op[0] not in ("resize", "letterbox", "rotate", "canny")]
# ops that change the grid or scan whole images: raise on (batch, space)
BATCH_ONLY = ["resize", "letterbox", "resize_blur_oklab", "rotate", "crop",
              "extract", "warp", "insert", "flood_fill", "motion_blur",
              "canny", "shen_castan", "apply_colormap"]
WINDOWED = ["gaussian_blur", "box_blur", "sharpen", "median_blur",
            "convolve", "convolve_separable", "sobel", "dilate_binary",
            "erode_binary", "open_binary", "threshold_adaptive_mean"]


def op_id(name, args) -> str:
    return f"{name}{args}"[:40]


def _args(args):
    from zignal_tpu_torch import Interpolation

    return tuple(Interpolation[a] if a == "BICUBIC" else a for a in args)


def _batch_only_call(b, name):
    from zignal_tpu_torch import (Colormap, Image, MotionBlur,
                                  SimilarityTransform)

    calls = {
        "resize": lambda: b.resize((16, 24)),
        "letterbox": lambda: b.letterbox(24),
        "resize_blur_oklab": lambda: b.resize_blur_oklab((16, 16)),
        "rotate": lambda: b.rotate(0.3),
        "crop": lambda: b.crop((2, 2, 20, 20)),
        "extract": lambda: b.extract((2, 2, 20, 20), 0.2),
        "warp": lambda: b.warp(SimilarityTransform()),
        "insert": lambda: b.insert(Image(4, 4, (1, 2, 3), device="cpu"),
                                   (2, 2, 6, 6)),
        "flood_fill": lambda: b.flood_fill(0, 0, (0, 0, 0)),
        "motion_blur": lambda: b.motion_blur(MotionBlur.linear(0.0, 5)),
        "canny": lambda: b.canny(),
        "shen_castan": lambda: b.shen_castan(),
        "apply_colormap": lambda: b.apply_colormap(Colormap.jet()),
    }
    return calls[name]()


def batch_mesh_body(world: int, files: list) -> dict:
    from zignal_tpu_torch import Blending, Colormap, Gray, ImageBatch
    from zignal_tpu_torch.parallel import make_mesh

    mesh1 = make_mesh(world, device="cpu")
    mesh2 = make_mesh((2, world // 2), ("batch", "space"), device="cpu")
    out = {}
    a1, a2 = arr(), arr(b=4, h=64)
    b1, b2 = ImageBatch(a1, mesh=mesh1), ImageBatch(a2, mesh=mesh2)
    for tag, b, ops in (("batch", b1, SWEEP_OPS), ("space", b2, SPACE_OPS)):
        for name, args in ops:
            key = f"{tag}/{op_id(name, args)}"
            res = _counted(out, key, lambda: getattr(b, name)(*_args(args)))
            out[key] = res.to_numpy()
            out[key + "/local_shape"] = tuple(res._dev.shape)
    for tag, b in (("batch", b1), ("space", b2)):
        other = b.gaussian_blur(3.0)
        for name in ("psnr", "ssim", "mean_pixel_error"):
            out[f"{tag}/{name}"] = _np(_counted(
                out, f"{tag}/{name}", lambda: getattr(b, name)(other)))
        vis, counts = b.diff(other, threshold=2.0)
        out[f"{tag}/diff"] = (vis.to_numpy(), _np(counts))
        out[f"{tag}/histogram"] = _np(_counted(out, f"{tag}/histogram",
                                               b.histogram))
        binary, thr = b.convert(Gray).threshold_otsu()
        out[f"{tag}/otsu"] = (binary.to_numpy(), thr)
        overlay = ImageBatch(arr(b=b.batch_size, h=b.rows, c=4, seed=5),
                             device="cpu")
        out[f"{tag}/blend"] = b.blend(overlay, Blending.MULTIPLY).to_numpy()
        out[f"{tag}/colormap"] = b.apply_colormap(
            Colormap.jet(min=0, max=255)).to_numpy()
        out[f"{tag}/convert_gray"] = b.convert(Gray).to_numpy()
        out[f"{tag}/getitem"] = b[1].to_numpy()
        out[f"{tag}/repr"] = repr(b)
        out[f"{tag}/sharding"] = repr(b.sharding)
    out["batch/resize_blur_oklab"] = _np(_counted(
        out, "batch/resize_blur_oklab",
        lambda: b1.resize_blur_oklab((16, 24), sigma=1.0)))
    out["batch/chain"] = b1.resize((16, 16)).gaussian_blur(1.0) \
        .convert(Gray).equalize().to_numpy()
    for name in BATCH_ONLY:
        out[f"space_raises/{name}"] = _error(
            lambda: _batch_only_call(b2, name))
    # construction: errors, with_mesh, from_paths
    out["err/batch"] = _error(lambda: ImageBatch(arr(b=3), mesh=mesh1))
    out["err/rows"] = _error(lambda: ImageBatch(arr(b=4, h=31), mesh=mesh2))
    out["err/device"] = _error(lambda: ImageBatch(a1, device="meta",
                                                  mesh=mesh1))
    out["err/no_device"] = _error(lambda: ImageBatch(a1))
    plain = ImageBatch(a1, device="cpu")
    moved = plain.with_mesh(mesh1)
    out["with_mesh"] = (moved.to_numpy(), moved.mesh is not None,
                        plain.mesh is None, moved._dev.shape[0])
    out["with_mesh/2d"] = moved.with_mesh(mesh2).to_numpy() if \
        a1.shape[1] % (world // 2) == 0 else None
    fb = ImageBatch.from_paths(files, mesh=mesh1)
    out["from_paths"] = (fb.to_numpy(), fb._dev.shape[0], fb.batch_size)
    fb2 = ImageBatch.from_paths(files[:2], mesh=mesh2)
    out["from_paths/2d"] = (fb2.to_numpy(), tuple(fb2._dev.shape))
    return out


BODIES = {"parallel": parallel_body, "batch_mesh": batch_mesh_body}


def _rank_main(rank, world, init, body, args, out_dir):
    torch.set_num_threads(1)
    from zignal_tpu_torch.parallel import init_distributed

    init_distributed(init, world, rank, device="cpu")
    try:
        res = BODIES[body](world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def run_ranks(world: int, body: str, tmp_path, args=(), timeout=240):
    """Every rank's result dict of ``BODIES[body]`` on ``world`` gloo
    ranks; raises if a rank fails or the ranks outlive ``timeout`` s."""
    import torch.multiprocessing as mp

    out_dir = str(tmp_path)
    init = f"file://{os.path.join(out_dir, 'rendezvous')}"
    ctx = mp.start_processes(_rank_main,
                             args=(world, init, body, args, out_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{body} ranks still running after "
                               f"{timeout} s")
    results = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results
