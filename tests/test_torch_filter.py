"""The config-3 filter chain and the windowed filters of the port
(ops/binary.py, ops/integral.py, ops/filter_chain.py, pipeline.filter_chain,
the ImageBatch methods, rgb_to_gray_u8) against the JAX package on JAX-CPU:
u8 outputs array_equal, float outputs within the bound stated below.
Inputs come from numpy with a seed and go to both packages as the same
arrays."""

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zignal_tpu as jz
from zignal_tpu import pipeline as jax_pipeline
from zignal_tpu.color._array import rgb_to_gray_u8 as jax_gray
from zignal_tpu.ops import binary as jax_binary
from zignal_tpu.ops import integral as jax_integral
from zignal_tpu.ops.pallas_filter import fused_blur_sharpen_morph as \
    jax_fused_filter

import zignal_tpu_torch as zp
from zignal_tpu_torch import pipeline
from zignal_tpu_torch.color._array import rgb_to_gray_u8
from zignal_tpu_torch.ops import binary, integral
from zignal_tpu_torch.ops import filter_chain as fc

# the shapes of tests/test_pallas_filter.py scaled down to <= 2x128x256,
# batched, and tiny planes the TPU kernel's gate refuses
CHAIN_CASES = [  # (shape, sigma, sharpen_radius, thr)
    ((128, 128), 2.0, 2, 128.0),
    ((64, 192), 1.0, 1, 90.0),
    ((96, 64), 3.5, 3, 200.0),
    ((125, 125), 2.0, 2, 128.0),
    ((128, 59), 2.0, 2, 128.0),
    ((50, 65), 2.0, 2, 128.0),
    ((3, 64, 128), 1.5, 2, 128.0),
    ((1, 64), 2.0, 2, 128.0),
    ((64, 1), 2.0, 2, 128.0),
    ((5, 7), 2.0, 2, 128.0),
    ((1, 1), 2.0, 2, 128.0),
    ((2, 40, 50), 2.0, 2, 127.5),
    ((40, 50), 2.0, 2, -1.0),
    ((40, 50), 2.0, 2, 300.0),
    ((40, 50), 0.0, 0, 128.0),
]


def _ids(cases):
    return ["x".join(map(str, c[0])) + f"-s{c[1]}-r{c[2]}-t{c[3]}"
            for c in cases]


def _struct(plan):
    """K2's FilterParams of ``plan`` as int32 words (the fields, thr and
    the reciprocal, the taps), as a launch at thr 0 packs them."""
    return np.frombuffer(plan.pack(0.0, False, False).raw, np.int32)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _mask(shape, seed, p=0.5):
    m = np.random.default_rng(seed).random(shape) < p
    return (m * 255).astype(np.uint8)


@pytest.mark.parametrize("thr", [128.0, 127.5, -1.0, 300.0, 254.99999])
def test_threshold_apply_matches_jax(thr):
    x = _u8((2, 20, 30), 1)
    x[0, 0, :4] = [0, 127, 128, 255]
    got = binary.threshold_apply(torch.from_numpy(x), thr).numpy()
    assert np.array_equal(got, np.asarray(jax_binary.threshold_apply(
        jnp.asarray(x), thr)))


def test_threshold_compares_in_f32_not_as_an_integer():
    x = torch.arange(256, dtype=torch.uint8)
    assert int(binary.threshold_apply(x, 127.5).sum()) == 128 * 255
    assert int(binary.threshold_apply(x, 127.0).sum()) == 128 * 255
    assert int(binary.threshold_apply(x, 126.9).sum()) == 129 * 255


@pytest.mark.parametrize("op", ["dilate", "erode", "open_morph",
                                "close_morph"])
@pytest.mark.parametrize("ksize,iterations", [(3, 1), (3, 2), (5, 1),
                                              (3, 0)])
def test_morphology_matches_jax(op, ksize, iterations):
    x = _mask((20, 31), 2, 0.6)
    x[5, 5] = 17   # any nonzero value is foreground
    got = getattr(binary, op)(torch.from_numpy(x), ksize, iterations)
    want = getattr(jax_binary, op)(jnp.asarray(x), ksize, iterations)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_morphology_is_per_plane_on_a_batch():
    x = _mask((3, 17, 12), 3)
    got = binary.close_morph(torch.from_numpy(x), 3, 1).numpy()
    for i in range(3):
        assert np.array_equal(got[i], np.asarray(jax_binary.close_morph(
            jnp.asarray(x[i]), 3, 1)))


@pytest.mark.parametrize("op", ["box_blur", "sharpen"])
@pytest.mark.parametrize("radius", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(20, 30, 3), (64, 47, 1), (1, 9, 4),
                                   (128, 96, 1)])
def test_box_blur_and_sharpen_match_jax(op, radius, shape):
    x = _u8(shape, 4)
    got = getattr(integral, op)(torch.from_numpy(x), radius).numpy()
    want = getattr(jax_integral, op)(jnp.asarray(x), radius)
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("h,w,radius", [(20, 30, 2), (20, 30, 127),
                                        (20, 30, 128), (300, 300, 128),
                                        (600, 520, 128), (257, 600, 200),
                                        (1024, 1024, 2)])
def test_sums_branch_follows_jax(h, w, radius):
    """sums_fit_f32 picks the branch the JAX package takes: f32 sums
    where exact_axis_apply reports a bound below 2^24, else int32."""
    spec = jax.ShapeDtypeStruct((h, w, 1), jnp.uint8)
    sums = jax.eval_shape(
        lambda a: jax_integral._box_sums_exact(a, radius)[0], spec)
    assert integral.sums_fit_f32(h, w, radius) == (sums.dtype == jnp.float32)


@pytest.mark.parametrize("op", ["box_blur", "sharpen"])
def test_integer_form_is_the_exact_rounding(op, monkeypatch):
    """The int32 quotient/remainder form (taken where the sums pass 2^24)
    equals floor(mean + 0.5) and floor(2t - mean + 0.5) in exact
    arithmetic."""
    x = _u8((9, 11, 2), 5)
    monkeypatch.setattr(integral, "sums_fit_f32", lambda *a: False)
    got = getattr(integral, op)(torch.from_numpy(x), 2).numpy()
    sums, area = integral._box_sums_exact(torch.from_numpy(x), 2)
    sums = sums.numpy()
    want = np.zeros_like(x)
    for idx in np.ndindex(x.shape):
        mean = Fraction(int(sums[idx]), int(area[idx[0], idx[1], 0]))
        v = mean if op == "box_blur" else 2 * int(x[idx]) - mean
        want[idx] = min(max(math.floor(v + Fraction(1, 2)), 0), 255)
    assert np.array_equal(got, want)


def test_f32_form_divides_as_the_compiled_program_does():
    """3570 / 28 is 127.5; the JAX program multiplies by f32(1/28) and
    gets 127.50001, so a sharpened 82 becomes 36, not 37."""
    mean = integral._mean_f32(torch.full((1, 1, 1), 3570, dtype=torch.int32),
                              np.full((1, 1, 1), 28, np.float32))
    assert float(mean) == float(np.float32(3570) * (np.float32(1) / 28))
    assert float(mean) != 127.5


@pytest.mark.parametrize("shape", [(2, 9, 5, 3), (1, 4, 4, 4)])
def test_rgb_to_gray_matches_jax(shape):
    x = _u8(shape, 6)
    x[0, 0, :4, :3] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]]
    got = rgb_to_gray_u8(torch.from_numpy(x[..., :3])).numpy()
    assert np.array_equal(got, np.asarray(jax_gray(jnp.asarray(x[..., :3]))))


@pytest.mark.parametrize("shape,sigma,radius,thr", CHAIN_CASES,
                         ids=_ids(CHAIN_CASES))
def test_filter_chain_reference_matches_jax(shape, sigma, radius, thr):
    x = _u8(shape, 7)
    got = fc.fused_blur_sharpen_morph_reference(torch.from_numpy(x), sigma,
                                                radius, thr)
    want = jax_pipeline.filter_chain(jnp.asarray(x), sigma, radius, thr)
    assert got.dtype == torch.uint8 and got.shape == x.shape
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_filter_chain_reference_matches_the_pallas_kernel_interpret():
    x = _u8((2, 64, 128), 8)
    got = fc.fused_blur_sharpen_morph_reference(torch.from_numpy(x))
    want = jax_fused_filter(jnp.asarray(x), 2.0, 2, 128.0, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _kernel_tiles(x, sigma, rs, thr, tile, tw=None):
    """A numpy transcription of filter_kernel's regions and index
    arithmetic, tile by tile (``tile`` rows, ``tw`` columns): input
    through the halo tables, blur width and height passes, blurred values
    zeroed outside the image, box sums as running sums, sharpen (f32 or
    int form) over the clamped window lengths, threshold, dilate as a row
    OR and a column OR with the outside set back to 0, erode as a row AND
    and a column AND."""
    h, w = x.shape
    tw = tile if tw is None else tw
    plan = fc._Plan(1, h, w, sigma, rs, "cpu")
    ty, tx = plan.ty.numpy(), plan.tx.numpy()
    f = dict(zip(fc._FIELDS, _struct(plan)))
    taps = _struct(plan)[len(fc._FIELDS) + 2:][:f["kb"]].astype(np.int64)
    hh, g = 2 + rs, 2 + rs + f["rb"]
    kb, ks = len(taps), 2 * rs + 1
    out = np.zeros_like(x)

    def inside(y, xx):
        return ((y >= 0) & (y < h))[:, None] & ((xx >= 0) & (xx < w))[None]

    def extent(i, n):
        return (np.minimum(i + rs, n - 1) - np.maximum(i - rs, 0)
                + 1).astype(np.float32)

    for y0 in range(0, h, tile):
        for x0 in range(0, w, tw):
            th, tcw = min(tile, h - y0), min(tw, w - x0)
            inp = x[ty[y0:y0 + th + 2 * g]][:, tx[x0:x0 + tcw + 2 * g]] \
                .astype(np.int64)
            bh, bw, mh, mw = th + 2 * hh, tcw + 2 * hh, th + 4, tcw + 4
            dh, dw = th + 2, tcw + 2
            a = sum(taps[k] * inp[:, k:k + bw] for k in range(kb))
            acc = sum(taps[k] * a[k:k + bh] for k in range(kb))
            bl = np.minimum((acc + 32768) >> 16, 255)
            bl[~inside(np.arange(y0 - hh, y0 - hh + bh),
                       np.arange(x0 - hh, x0 - hh + bw))] = 0
            boxw = np.cumsum(np.pad(bl, ((0, 0), (1, 0))), axis=1)
            boxw = boxw[:, ks:ks + mw] - boxw[:, :mw]
            s = np.cumsum(np.pad(boxw, ((1, 0), (0, 0))), axis=0)
            s = s[ks:ks + mh] - s[:mh]
            b = bl[rs:rs + mh, rs:rs + mw]
            ys, xs = np.arange(y0 - 2, y0 - 2 + mh), np.arange(x0 - 2,
                                                               x0 - 2 + mw)
            area = extent(ys, h)[:, None] * extent(xs, w)[None]
            if f["int_form"]:
                ai = np.maximum(area.astype(np.int64), 1)
                q, rem = s // ai, s % ai
                sh = np.clip(2 * b - q - (2 * rem > ai), 0, 255)
            else:
                with np.errstate(divide="ignore", invalid="ignore"):
                    mean = s.astype(np.float32) * (np.float32(1) / area)
                    v = np.float32(2) * b.astype(np.float32) - mean
                sh = np.clip(np.floor(v + np.float32(0.5)), 0, 255)
            mask = np.where(inside(ys, xs)
                            & (sh.astype(np.float32) > np.float32(thr)),
                            255, 0)
            rows = mask[:, 0:dw] | mask[:, 1:dw + 1] | mask[:, 2:dw + 2]
            dil = rows[0:dh] | rows[1:dh + 1] | rows[2:dh + 2]
            dil[~inside(np.arange(y0 - 1, y0 + th + 1),
                        np.arange(x0 - 1, x0 + tcw + 1))] = 0
            rows = dil[:, 0:tcw] & dil[:, 1:tcw + 1] & dil[:, 2:tcw + 2]
            out[y0:y0 + th, x0:x0 + tcw] = rows[0:th] & rows[1:th + 1] \
                & rows[2:th + 2]
    return out


# -- the streamed kernel, transcribed: 32 lanes as numpy vectors, words as
#    uint64 holding 32-bit values, every op of streamed_filter_kernel

_M32 = np.uint64(0xFFFFFFFF)


def _byte_perm(x, y, sel):
    src = [(x >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)] + \
          [(y >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> 4 * n) & 7] << np.uint64(8 * n)
    return out


def _fshr(lo, hi, sh):  # __funnelshift_r
    return (((hi << np.uint64(32)) | lo) >> np.uint64(sh)) & _M32


def _fshl(lo, hi, sh):  # __funnelshift_l
    return ((((hi << np.uint64(32)) | lo) << np.uint64(sh)) >> np.uint64(32)) \
        & _M32


def _shfl_up(v):  # __shfl_up_sync(v, 1) over the last axis: lane 0 keeps
    return np.concatenate([v[..., :1], v[..., :-1]], -1)  # its own


def _shfl_down(v):  # __shfl_down_sync(v, 1): lane 31 keeps its own
    return np.concatenate([v[..., 1:], v[..., -1:]], -1)


def _byte_pairs(ws):
    lo = [_byte_perm(w, np.zeros_like(w), 0x4240) for w in ws]
    hi = [_byte_perm(w, np.zeros_like(w), 0x4341) for w in ws]
    e = []
    for m in range(len(ws)):
        e += [lo[m], hi[m]]
        if m + 1 < len(ws):
            e += [_fshr(lo[m], lo[m + 1], 16), _fshr(hi[m], hi[m + 1], 16)]
    return e


def _kernel_stream(x, sigma, rs, thr, vec_in=True):
    """A numpy transcription of streamed_filter_kernel, every warp of the
    plan at once (a row of each array a warp, a column a lane): the plan's
    strips and segments, the ring of input rows (16-byte copies, or the
    lane's bytes through the padded blur's halo tables), the width pass
    four taps a __dp4a, the ring of width-pass rows read 4 blurred rows at
    a time, the box sums, the sharpen, the dilate and the erode with the windows
    carried from row to row, the warm-up rows that skip the stages whose
    window is not full, the shuffles' edge lanes, and the rows and columns
    outside the plane."""
    planes = x.reshape(-1, *x.shape[-2:])
    b, hh, ww = planes.shape
    plan = fc._Plan(b, hh, ww, sigma, rs, "cpu")
    f = dict(zip(fc._FIELDS, _struct(plan).tolist()))
    assert f["stream"] == 1 and f["int_form"] == 0
    taps0 = len(fc._FIELDS) + 2 + fc.MAX_TAPS
    kb = f["skb"]
    staps = [int(t) for t in _struct(plan)[taps0:taps0 + kb]]
    rb = kb // 2
    a = (4 - rb % 4) % 4
    nt = (kb + 3) // 4  # __dp4a a column
    nw = (a + 4 * nt + 2) // 4 + 1
    tq = [sum(staps[4 * c + b] << 8 * b for b in range(4) if 4 * c + b < kb)
          for c in range(nt)]
    assert max(staps) <= 255
    g = 2 + rs + rb
    full = np.float32(2 * rs + 1)
    inv_full = plan.inv_full.view(np.float32)
    sty, stx = plan.sty.numpy(), plan.stx.numpy()
    assert len(sty) == hh + 2 * g and len(stx) == ww + 2 * g
    u64 = np.uint64

    # the warps: plane z, segment rows [y0, y1), strip columns from cb
    item = np.arange(b * f["strips"] * f["segs"])[:, None]
    z, rem = np.divmod(item, f["strips"] * f["segs"])
    sy, sx = np.divmod(rem, f["strips"])
    x0 = sx * f["sw"]
    cb = x0 - f["h4"]
    y0 = sy * f["seg"]
    y1 = np.minimum(y0 + f["seg"], hh)
    n = y1 - y0 + 2 * g
    o = (cb - rb) & ~15
    e = cb - rb - o
    vec = vec_in & (ww % 16 == 0) & (o >= 0) & (o + 160 <= ww)
    lane = np.arange(32)[None]
    cols = (cb + 4 * lane)[..., None] + np.arange(4)  # [warps, 32, 4]
    inside = (cols >= 0) & (cols < ww)
    colmask = sum(np.where(inside[..., j], u64(0xFF << 8 * j), u64(0))
                  for j in range(4))
    ax = (np.minimum(cols + rs, ww - 1) - np.maximum(cols - rs, 0)
          + 1).astype(np.float32)
    cfull = (cols >= rs) & (cols + rs < ww)
    out_lane = (cols[..., 0] >= x0) & (cols[..., 0] < x0 + f["sw"]) \
        & (cols[..., 0] < ww)
    ring_cols = np.where(vec, o + np.arange(160),
                         stx[np.clip(o + np.arange(160) + g, 0,
                                     ww + 2 * g - 1)])
    out = np.full(planes.shape, 7, np.uint8)  # every byte is written

    def inplane(r):
        return (r >= 0) & (r < hh)

    def over(bv, s, ay, ax, inv):  # the f32 form: int forms take the tiles
        with np.errstate(invalid="ignore"):
            mean = s.astype(np.float32) * inv
        v = np.float32(2) * bv.astype(np.float32) - mean
        return np.clip(np.floor(v + np.float32(0.5)), 0, 255) \
            > np.float32(thr)

    def zeros():
        return np.zeros(item.shape[:1] + (32,), np.uint64)

    ar = {}                     # width-pass rows (a ring of 32)
    blr = {}                    # blurred rows (a ring of 16)
    w02, w13 = {}, {}           # box width sums (a ring of 8)
    s02, s13 = zeros(), zeros()
    hm0 = hm1 = hm2 = he0 = he1 = he2 = zeros()
    for i0 in range(0, int(n.max()), 4):
        for i in range(i0, i0 + 4):  # 1. width pass
            r = y0 - g + np.minimum(i, n - 1)
            r = np.where(inplane(r), r, sty[np.clip(r + g, 0,
                                                    len(sty) - 1)])
            row = planes[z, r, ring_cols].astype(np.uint64)  # the ring row
            base = (e & ~3) + 4 * lane
            ws = [sum(np.take_along_axis(row, base + 4 * m + k, 1)
                      << u64(8 * k) for k in range(4)) for m in range(nw)]
            av = []
            for j in range(4):  # four taps a __dp4a of the window at a + j
                acc = 0
                for c in range(nt):
                    at = a + j + 4 * c
                    win = _fshr(ws[at >> 2], ws[(at >> 2) + 1], 8 * (at & 3)) \
                        if at & 3 else ws[at >> 2]
                    acc = acc + sum(((win >> u64(8 * t)) & u64(0xFF))
                                    * u64((tq[c] >> 8 * t) & 0xFF)
                                    for t in range(4))
                assert (acc < 2 ** 16).all()
                av.append(acc)
            ar[i % 32] = (_byte_perm(av[0], av[2], 0x5410),
                          _byte_perm(av[1], av[3], 0x5410))
        if i0 + 4 > 2 * rb:  # 2. height pass: 4 rows from kb + 3
            for r4 in range(4):
                i = i0 + r4
                blw = zeros()
                for j in range(4):
                    acc = 32768
                    for k in range(kb):
                        pr = ar.get((i - 2 * rb + k) % 32,
                                    (zeros(), zeros()))[j & 1]
                        acc = acc + staps[k] * ((pr >> u64(16 * (j >> 1)))
                                                & u64(0xFFFF)).astype(np.int64)
                    blw |= np.minimum(acc >> 16, 255).astype(np.uint64) \
                        << u64(8 * j)
                br = y0 - g + i - rb
                blr[i % 16] = np.where(inplane(br), blw & colmask, u64(0))
        for i in range(max(i0, 2 * rb), i0 + 4):  # 3. per row
            live = i < n  # a warp past its n has stopped
            br = y0 - g + i - rb
            blw = blr[i % 16]
            q = _byte_pairs([_shfl_up(blw), blw, _shfl_down(blw)])
            n02, n13 = q[4], q[5]
            for d in range(1, rs + 1):
                n02 = n02 + q[4 - d] + q[4 + d]
                n13 = n13 + q[5 - d] + q[5 + d]
            old = (i - 2 * rs - 1) % 8
            s02 = (s02 + n02 - w02.get(old, 0)) & _M32
            s13 = (s13 + n13 - w13.get(old, 0)) & _M32
            w02[i % 8], w13[i % 8] = n02, n13
            if i < 2 * g - 4:
                continue
            my = br - rs
            bc = blr[(i - rs) % 16]
            s = [s02 & u64(0xFFFF), s13 & u64(0xFFFF), s02 >> u64(16),
                 s13 >> u64(16)]
            row_full = (my >= rs) & (my + rs < hh)
            ay = np.where(row_full, full, (np.minimum(my + rs, hh - 1)
                                           - np.maximum(my - rs, 0)
                                           + 1).astype(np.float32))
            mw = zeros()
            for j in range(4):
                bv = ((bc >> u64(8 * j)) & u64(0xFF)).astype(np.int64)
                with np.errstate(divide="ignore"):
                    invc = np.where(cfull[..., j], inv_full,
                                    np.float32(1) / (full * ax[..., j]))
                    inv = np.where(row_full, invc,
                                   np.float32(1) / (ay * ax[..., j]))
                m = over(bv, s[j].astype(np.int64), ay, ax[..., j], inv)
                mw |= np.where(m, u64(0xFF << 8 * j), u64(0))
            mw = np.where(inplane(my), mw & colmask, u64(0))
            hm0, hm1, hm2 = (mw | _fshl(_shfl_up(mw), mw, 8)
                             | _fshr(mw, _shfl_down(mw), 8)), hm0, hm1
            if i < 2 * g - 2:
                continue
            d = np.where(inplane(my - 1), (hm0 | hm1 | hm2) & colmask,
                         u64(0))
            he0, he1, he2 = (d & _fshl(_shfl_up(d), d, 8)
                             & _fshr(d, _shfl_down(d), 8)), he0, he1
            if i < 2 * g:
                continue
            v = he0 & he1 & he2
            for j in range(4):
                put = out_lane & live & (cols[..., j] < ww)
                wz, wl = np.nonzero(put)
                out[z[wz, 0], (my - 2)[wz, 0], cols[wz, wl, j]] = \
                    (v[wz, wl] >> u64(8 * j)) & u64(0xFF)
    return out.reshape(x.shape)


# the streamed kernel's edges: planes just below, at and above one strip
# width (120 output columns at r <= 2, 112 at r 3) and two, and one and two
# segment lengths (9 rows where the card's warps outnumber the rows), and
# heights under the 20-row warm-up
STREAM_SIDES = [(1, 120), (5, 119), (19, 121), (21, 240), (8, 241), (9, 64),
                (10, 113), (18, 250), (64, 129)]


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("hw", STREAM_SIDES, ids=lambda s: "x".join(map(str, s)))
def test_streamed_schedule_reproduces_plain(batch, hw, monkeypatch):
    """The streamed kernel's strips, segments, warm-up rows, rings and
    carried windows, transcribed, give the plain version's mask at the
    main paths' filters, on 16-byte rows (cp.async) and through the halo
    tables (the gather), the edge strips through the tables; at every
    segment length, those the plan leaves to the tiles for their warm-up
    too."""
    monkeypatch.setattr(fc, "MAX_WARMUP", float("inf"))
    x = _u8((batch, *hw), 31)
    for sigma, rs, thr in ((2.0, 2, 128.0), (1.0, 1, 127.5), (1.5, 3, 90.0)):
        want = fc.fused_blur_sharpen_morph_reference(torch.from_numpy(x),
                                                     sigma, rs, thr).numpy()
        for vec_in in (True, False):
            got = _kernel_stream(x, sigma, rs, thr, vec_in)
            assert np.array_equal(got, want), (sigma, rs, vec_in)


def test_streamed_schedule_at_the_main_path_geometry():
    """One plane of 1024^2 at sigma 2, r 2: 9 strips (the last one 64
    columns wide, its right edge through the tables) of 114 segments of 9
    rows."""
    x = _u8((1, 1024, 1024), 32)
    want = fc.fused_blur_sharpen_morph_reference(torch.from_numpy(x))
    assert np.array_equal(_kernel_stream(x, 2.0, 2, 128.0), want.numpy())


def test_int_form_takes_the_tile_path(monkeypatch):
    """The streamed kernel computes the sharpen's f32 form only. JAX's
    bound rule takes the int form only past r = 3, where the tile kernel
    runs anyway; where it would take it at r <= 3, the plan sends the
    filter to the tile kernel, whose transcription gives the plain mask."""
    assert all(integral.sums_fit_f32(h, w, rs) for h, w in
               ((1, 1), (1024, 1024), (1 << 20, 1 << 20)) for rs in range(4))
    monkeypatch.setattr(fc, "sums_fit_f32", lambda *a: False)
    monkeypatch.setattr(integral, "sums_fit_f32", lambda *a: False)
    x = _u8((45, 130), 33)
    for sigma, rs, thr in ((1.5, 3, 120.0), (2.0, 2, 128.0), (0.5, 0, 60.0)):
        plan = fc._Plan(1, 45, 130, sigma, rs, "cpu")
        f = dict(zip(fc._FIELDS, _struct(plan).tolist()))
        assert plan.stream is None and (f["stream"], f["int_form"]) == (0, 1)
        assert fc._stream_plan(fc._taps(sigma), rs, 45, 130, 1, 132) is None
        want = fc.fused_blur_sharpen_morph_reference(torch.from_numpy(x),
                                                     sigma, rs, thr)
        assert np.array_equal(_kernel_tiles(x, sigma, rs, thr, 16),
                              want.numpy()), (sigma, rs)


@pytest.mark.parametrize("b,sms", [(16, 132), (1, 132), (16, 114), (4, 132)])
def test_stream_plan_fits_and_fills_the_card(b, sms):
    """At the main path's planes the streamed plan's warps fit one wave of
    resident warps (16 an SM: 128 registers, 8,832 bytes of shared memory
    and the 1 KB a block reserves, of 228 KB) and give every SM at least 7
    warps, with segments of at least 9 rows."""
    smem = 4 * 160 + 2 * 32 * 32 * 4  # the kernel's rings: 4 input rows of
    assert fc.RESIDENT_WARPS * (smem + 1024) <= 233472  # 160 B, 32 of 2 words
    st = fc._stream_plan(fc._taps(2.0), 2, 1024, 1024, b, sms)
    assert (st.kb, st.h4, st.sw, st.strips) == (13, 4, 120, 9)
    assert st.warps == b * st.strips * st.segs
    assert 7 * sms <= st.warps <= fc.RESIDENT_WARPS * sms
    assert st.seg >= fc.MIN_SEG_ROWS
    assert (st.segs - 1) * st.seg < 1024 <= st.segs * st.seg


def test_stream_plan_at_the_main_paths():
    """B=16 of 1024^2 takes 14 segments of 74 rows (2016 warps), B=1 114 of
    9 (1026 warps)."""
    big = fc._stream_plan(fc._taps(2.0), 2, 1024, 1024, 16, 132)
    assert (big.seg, big.segs, big.warps) == (74, 14, 2016)
    small = fc._stream_plan(fc._taps(2.0), 2, 1024, 1024, 1, 132)
    assert (small.seg, small.segs, small.warps) == (9, 114, 1026)


@pytest.mark.parametrize("b,h,w", [(16, 1024, 1024), (1, 1024, 1024),
                                   (1, 63, 129), (3, 1, 65), (1, 1, 1),
                                   (2, 5000, 37)])
def test_stream_plan_covers_every_row_and_column(b, h, w, monkeypatch):
    """Every (0 < sigma <= 2, r <= 3) filter can take the streamed kernel:
    its strips and segments cover the plane, once, its taps are the blur's,
    centred among zeros in 7 or 13, and its halo tables reach g = 2 + r +
    (padded taps) // 2 past each border."""
    monkeypatch.setattr(fc, "MAX_WARMUP", float("inf"))
    for sigma in np.arange(0.5, 2.01, 0.5):
        kint = fc._taps(float(sigma))
        for rs in range(4):
            plan = fc._Plan(b, h, w, float(sigma), rs, "cpu")
            f = dict(zip(fc._FIELDS, _struct(plan).tolist()))
            st = plan.stream
            assert f["stream"] == 1 and st is not None
            assert f["skb"] == st.kb == (7 if len(kint) <= 7 else 13)
            assert f["h4"] % 4 == 0 and f["h4"] >= rs + 2
            assert f["sw"] == 128 - 2 * f["h4"] and f["sw"] % 4 == 0
            assert (f["strips"] - 1) * f["sw"] < w <= f["strips"] * f["sw"]
            assert (f["segs"] - 1) * f["seg"] < h <= f["segs"] * f["seg"]
            at = len(fc._FIELDS) + 2 + fc.MAX_TAPS
            staps = _struct(plan)[at:at + fc._STAPS]
            pad = (st.kb - len(kint)) // 2
            assert np.array_equal(staps[pad:pad + len(kint)], kint)
            assert not staps[:pad].any() and not staps[pad + len(kint):].any()
            g = 2 + rs + st.kb // 2
            assert len(plan.sty) == h + 2 * g and len(plan.stx) == w + 2 * g


def test_stream_plan_sends_wide_filters_to_the_tile_path():
    """A blur of more than 13 taps, a sharpen radius above 3, a tap above
    255 (sigma 0's one tap of 256 is not a byte) or taps that sum past 257
    (two columns a word would carry) take the tile kernel, whose plan is
    the one it always had."""
    assert len(fc._taps(3.5)) > 13
    assert list(fc._taps(0.0)) == [256]
    assert fc._stream_plan(fc._taps(0.0), 2, 1024, 1024, 16, 132) is None
    assert fc._stream_plan(fc._taps(3.5), 2, 1024, 1024, 16, 132) is None
    assert fc._stream_plan(fc._taps(2.0), 4, 1024, 1024, 16, 132) is None
    heavy = fc._taps(2.0).copy()
    heavy[6] += 1
    assert heavy.sum() == 258
    assert fc._stream_plan(heavy, 2, 1024, 1024, 16, 132) is None
    plan = fc._Plan(16, 1024, 1024, 3.5, 3, "cpu")
    f = dict(zip(fc._FIELDS, _struct(plan).tolist()))
    assert plan.stream is None and f["stream"] == 0
    assert (f["th"], f["tw"]) == (plan.tile.th, plan.tile.tw)


def test_stream_plan_leaves_warm_up_heavy_segments_to_the_tiles():
    """A segment whose 2 g warm-up rows exceed 9/4 of its rows takes the
    tile kernel: at B=1 of 1024^2 (9-row segments) r 3 with 13 taps (22
    rows) does, r 2 (20) and 7 taps at r 3 (16) stream; at B=2 (10-row
    segments) and B=16 every filter streams; a plane of one row never
    does."""
    def plan(sigma, rs, b, h=1024, w=1024):
        return fc._stream_plan(fc._taps(sigma), rs, h, w, b, 132)

    assert plan(1.5, 3, 1) is None and plan(2.0, 3, 1) is None
    assert plan(2.0, 2, 1).seg == plan(1.0, 3, 1).seg == 9
    for sigma in (0.5, 1.0, 1.5, 2.0):
        for rs in range(4):
            assert plan(sigma, rs, 2) is not None
            assert plan(sigma, rs, 16) is not None
            assert plan(sigma, rs, 3, 1, 65) is None
    p = fc._Plan(1, 1024, 1024, 1.5, 3, "cpu")
    f = dict(zip(fc._FIELDS, _struct(p).tolist()))
    assert p.stream is None and f["stream"] == 0
    assert (f["th"], f["tw"]) == (p.tile.th, p.tile.tw)


def test_streamed_counter_is_a_plain_integer_beside_launches():
    assert isinstance(fc.STREAMED, int) and isinstance(fc.LAUNCHES, int)
    x = _u8((2, 48, 80), 34)
    before = (fc.LAUNCHES, fc.STREAMED)
    pipeline.filter_chain(torch.from_numpy(x))
    assert (fc.LAUNCHES, fc.STREAMED) == before  # the CPU runs no kernel


@pytest.mark.parametrize("shape,sigma,radius,thr,tile", [
    ((70, 45), 2.0, 2, 128.0, 32),
    ((70, 45), 2.0, 2, 128.0, 8),
    ((37, 53), 3.5, 3, 200.0, 16),
    ((40, 50), 1.0, 1, -1.0, 8),
    ((5, 7), 2.0, 2, 128.0, 32),
    ((1, 20), 2.0, 2, 100.0, 8),
    ((33, 17), 0.0, 0, 127.5, 8),
])
def test_kernel_tiling_reproduces_plain(shape, sigma, radius, thr, tile):
    """The tables, regions and halo zeroing the CUDA kernel relies on give
    the plain version's mask at ragged edge tiles, tiny planes and a mask
    that touches the border (thr -1: everything is 255)."""
    x = _u8(shape, 9)
    want = fc.fused_blur_sharpen_morph_reference(torch.from_numpy(x), sigma,
                                                 radius, thr)
    assert np.array_equal(_kernel_tiles(x, sigma, radius, thr, tile),
                          want.numpy())


def test_kernel_tiling_reproduces_plain_in_the_int_form(monkeypatch):
    monkeypatch.setattr(fc, "sums_fit_f32", lambda *a: False)
    monkeypatch.setattr(integral, "sums_fit_f32", lambda *a: False)
    x = _u8((45, 38), 10)
    want = fc.fused_blur_sharpen_morph_reference(torch.from_numpy(x), 1.5, 3,
                                                 120.0)
    assert np.array_equal(_kernel_tiles(x, 1.5, 3, 120.0, 16), want.numpy())


@pytest.mark.parametrize("rb,rs,tile", [(6, 2, 32), (90, 2, 32), (12, 60, 32),
                                        (200, 2, 16)])
def test_tile_plan_fits_shared_memory(rb, rs, tile):
    """The plan for B=16 planes of tile x tile pixels (and of 1024^2)
    fits a block, with a tile at least 4 columns wide."""
    for side in (tile, 1024):
        plan = fc._tile_plan(rb, rs, side, side, 16, 132)
        assert plan.smem <= 232448
        assert plan.tw >= 4 and plan.tw % 4 == 0
        assert plan.tw + 2 * (rs + 2) <= 1 << plan.lg_bw


def test_tile_plan_rejects_radius_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        fc._tile_plan(12, 100, 1024, 1024, 1, 132)


@pytest.mark.parametrize("b,h,w", [(16, 1024, 1024), (1, 1024, 1024),
                                   (1, 63, 129), (3, 1, 65), (1, 1, 1)])
def test_tile_plans_fit_for_every_main_sigma_and_radius(b, h, w):
    """Every (sigma <= 5, r <= 3) plan fits 232,448 bytes, its regions
    follow one another in order, 16-byte aligned, and hold the kernel's
    reads: the input rows plus slack, the blur width pass plus 8 rows
    that a vertical pass may read past its region."""
    for sigma in np.arange(0.0, 5.01, 0.5):
        rb = fc.blur_radius(float(sigma))
        for rs in range(4):
            p = fc._tile_plan(rb, rs, h, w, b, 132)
            hh, g, bw = rs + 2, rs + 2 + rb, 1 << p.lg_bw
            ih = p.th + 2 * g
            assert p.smem <= 232448
            assert p.tw % 4 == 0 and p.tw + 2 * hh <= bw
            assert p.iws % 16 == 0 and p.iws >= p.tw + 2 * g + 16
            assert p.off_a >= ih * p.iws + 16
            assert p.off_bl - p.off_a == 4 * (ih + fc.ROWS) * bw
            assert p.off_m0 >= p.off_bl + (p.th + 2 * hh) * bw + 16
            assert p.off_m1 >= p.off_m0 + (p.th + 4) * bw + 16
            assert all(o % 16 == 0 for o in (p.off_a, p.off_bl, p.off_m0,
                                             p.off_m1))


def test_tile_plan_follows_the_grid():
    """B=16 of 1024^2 takes the first tile of the list; B=1 a smaller one,
    so the grid still gives every SM 4 blocks."""
    big = fc._tile_plan(6, 2, 1024, 1024, 16, 132)
    assert (1 << big.lg_bw, big.th, big.tw) == (64, 56, 56)
    small = fc._tile_plan(6, 2, 1024, 1024, 1, 132)
    assert small.blocks >= 4 * 132
    assert small.th * small.tw < big.th * big.tw


@pytest.mark.parametrize("hw", [(63, 129), (64, 65), (65, 64), (127, 63),
                                (129, 127), (1, 65), (65, 1), (1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("tile", [fc.TILES[0], fc.TILES[3], fc.TILES[8]],
                         ids=lambda t: f"bw{1 << t[0]}-th{t[1]}")
def test_kernel_tiling_reproduces_plain_at_real_tiles(hw, tile):
    """The kernel's own tile shapes, on planes below, at and above the
    tile sides: the numpy transcription equals the plain version."""
    x = _u8(hw, 23)
    plan = fc.TilePlan(tile[0], tile[1], fc.blur_radius(2.0), 2)
    for sigma, rs, thr in ((2.0, 2, 128.0), (1.0, 1, 127.5)):
        want = fc.fused_blur_sharpen_morph_reference(torch.from_numpy(x),
                                                     sigma, rs, thr)
        got = _kernel_tiles(x, sigma, rs, thr, plan.th, plan.tw)
        assert np.array_equal(got, want.numpy()), (sigma, rs)


@pytest.mark.parametrize("hw", [(300, 1024), (63, 129), (64, 65), (65, 64),
                                (129, 127), (1, 65), (65, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_interior_tiles_read_contiguous_rows(hw):
    """Where the kernel's interior test holds, its halo tables are the
    identity, so a contiguous (and, on 16-byte rows, cp.async) staging
    reads what the tables would; the 16-byte chunks stay inside the row
    and the staged row. Planes below, at and above the tile sides."""
    h, w = hw
    n_in = 0
    for sigma, rs in ((2.0, 2), (1.0, 1), (3.5, 3)):
        plan = fc._Plan(1, h, w, sigma, rs, "cpu")
        f = dict(zip(fc._FIELDS, _struct(plan)))
        g = 2 + rs + f["rb"]
        ty, tx = plan.ty.numpy(), plan.tx.numpy()
        for y0 in range(0, h, f["th"]):
            for x0 in range(0, w, f["tw"]):
                th, tw = min(f["th"], h - y0), min(f["tw"], w - x0)
                if not (y0 >= g and y0 + th + g <= h and x0 >= g
                        and x0 + tw + g <= w):
                    continue
                n_in += 1
                assert np.array_equal(ty[y0:y0 + th + 2 * g],
                                      np.arange(y0 - g, y0 + th + g))
                assert np.array_equal(tx[x0:x0 + tw + 2 * g],
                                      np.arange(x0 - g, x0 + tw + g))
                cs = (x0 - g) & ~15
                nch = (x0 - g - cs + tw + 2 * g + 15) >> 4
                if w % 16 == 0:
                    assert 0 <= cs and cs + 16 * nch <= w
                assert 16 * nch <= f["iws"]
    assert n_in > 0 or min(h, w) < 128


def test_pipeline_filter_chain_on_cpu_matches_jax_without_launching():
    x = _u8((2, 48, 80), 11)
    before = fc.LAUNCHES
    got = pipeline.filter_chain(torch.from_numpy(x))
    assert fc.LAUNCHES == before
    want = jax_pipeline.filter_chain(jnp.asarray(x))
    assert np.array_equal(got.numpy(), np.asarray(want))
    one = pipeline.filter_chain(torch.from_numpy(x[1]), 1.0, 1, 100)
    assert np.array_equal(one.numpy(), np.asarray(
        jax_pipeline.filter_chain(jnp.asarray(x[1]), 1.0, 1, 100)))


def test_filter_chain_raises_off_cpu_without_a_kernel():
    x = torch.empty((8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        pipeline.filter_chain(x)


@pytest.mark.parametrize("args,err", [
    (((1, 8, 8, 3), 2.0, 2), "\\[H, W\\] or \\[B, H, W\\]"),
    (((0, 8), 2.0, 2), "at least 1"),
    (((8, 8), -1.0, 2), "sigma"),
    (((8, 8), float("nan"), 2), "sigma"),
    (((8, 8), 2.0, -1), "sharpen radius"),
])
def test_filter_chain_rejects_bad_arguments(args, err):
    shape, sigma, radius = args
    with pytest.raises(ValueError, match=err):
        pipeline.filter_chain(torch.zeros(shape, dtype=torch.uint8), sigma,
                              radius)


def test_unported_inputs_raise_not_implemented():
    """Float inputs are ported, and integer dtypes other than uint8 take
    the JAX package's float route (below); complex inputs are not
    ported."""
    x = torch.zeros((1, 8, 8, 3))
    for op in (integral.box_blur, integral.sharpen):
        assert torch.equal(op(x, 1), x)
        assert op(x.to(torch.int32), 1).dtype == torch.int32
        with pytest.raises(NotImplementedError, match="complex64 is not "
                                                      "ported"):
            op(x.to(torch.complex64), 1)


# integer inputs other than u8, full range for 16 bits and +-2^16 for
# int32, so the JAX package's f32 summed-area table is exact on them
INT_DTYPES = [(np.int16, -32768, 32768), (np.uint16, 0, 65536),
              (np.int32, -65536, 65536)]


@pytest.mark.parametrize("dtype,lo,hi", INT_DTYPES,
                         ids=lambda d: getattr(d, "__name__", str(d)))
@pytest.mark.parametrize("op", ["box_blur", "sharpen"])
@pytest.mark.parametrize("radius", [1, 2, 3])
def test_integer_box_blur_and_sharpen_match_jax(dtype, lo, hi, op, radius):
    """The JAX package's float route: f32 window means converted back to
    the input's dtype as XLA converts (truncated, saturated; sharpen's
    2x - mean leaves the range at the extremes). Equal, and of the
    input's dtype."""
    x = np.random.default_rng(24).integers(lo, hi, (8, 9, 1)).astype(dtype)
    x[0, 0, 0], x[0, 1, 0] = lo, hi - 1
    got = getattr(integral, op)(torch.from_numpy(x), radius).numpy()
    want = np.asarray(getattr(jax_integral, op)(jnp.asarray(x), radius))
    assert got.dtype == want.dtype == dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("method,radius", [("box_blur", 2), ("sharpen", 1),
                                           ("sharpen", 3), ("box_blur", 0)])
def test_image_batch_clamped_filters_match_jax(channels, method, radius):
    x = _u8((2, 33, 40, channels), 12)
    got = getattr(zp.ImageBatch(x, device="cpu"), method)(radius)
    want = getattr(jz.ImageBatch(x), method)(radius)
    assert np.array_equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("method", ["dilate_binary", "erode_binary",
                                    "open_binary", "close_binary"])
def test_image_batch_morphology_matches_jax(channels, method):
    x = _u8((2, 21, 30, channels), 13)
    x[..., :3] = (x[..., :3] > 140) * 255
    for ksize, iterations in ((3, 1), (5, 2), (3, 0)):
        got = getattr(zp.ImageBatch(x, device="cpu"), method)(ksize,
                                                               iterations)
        want = getattr(jz.ImageBatch(x), method)(ksize, iterations)
        assert got.channels == 1
        assert np.array_equal(got.to_numpy(), want.to_numpy())


def test_image_batch_filter_validation_matches_jax():
    x = _u8((1, 8, 8, 3), 0)
    for method, args in (("box_blur", (-1,)), ("sharpen", (-2,)),
                         ("dilate_binary", (4,)), ("erode_binary", (1,)),
                         ("open_binary", (3, -1))):
        with pytest.raises(ValueError):
            getattr(jz.ImageBatch(x), method)(*args)
        with pytest.raises(ValueError):
            getattr(zp.ImageBatch(x, device="cpu"), method)(*args)


# -- integral image, float box blur and sharpen, adaptive threshold -------

def _dyadic(shape, seed):
    """0-1 floats k/256: every SAT entry of a small plane is exact in f32,
    so the JAX package's f32 SAT is exact on them."""
    return (_u8(shape, seed) / np.float32(256)).astype(np.float32)


@pytest.mark.parametrize("kind", ["u8", "int-valued f32", "dyadic f32"])
@pytest.mark.parametrize("shape", [(20, 30, 3), (33, 7, 1), (64, 64, 1),
                                   (2, 9, 11, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_integral_image_equals_jax_where_jax_is_exact(kind, shape):
    """Below 2^24 a SAT entry is exact in the JAX package's f32 cumsums
    and in the port's int64 / f64 sums cast once, so both agree bit for
    bit (255 * H * W < 2^24 for every shape here)."""
    x = _u8(shape, 14)
    if kind == "int-valued f32":
        x = x.astype(np.float32)
    elif kind == "dyadic f32":
        x = _dyadic(shape, 14)
    got = integral.integral_image(torch.from_numpy(x)).numpy()
    for i in np.ndindex(shape[:-3]):
        assert np.array_equal(got[i], np.asarray(
            jax_integral.integral_image(jnp.asarray(x[i]))))


def test_integral_image_is_exact_where_the_f32_sat_is_not():
    """Past 2^24 the JAX package's f32 running sums round (ROADMAP §3:
    on a random u8 plane 9,336 entries of 512^2 differ, by up to 2); the
    port's int64 sums cast once are the true sums, correctly rounded, on
    any device."""
    x = _u8((512, 512, 1), 19)
    got = integral.integral_image(torch.from_numpy(x)).numpy()[..., 0]
    truth = x[..., 0].astype(np.int64).cumsum(0).cumsum(1).astype(np.float32)
    assert np.array_equal(got, truth)
    jax_out = np.asarray(jax_integral.integral_image(jnp.asarray(x)))[..., 0]
    assert not np.array_equal(jax_out, truth)


# float box blur / sharpen bounds (max-abs): against the JAX package on
# data its f32 SAT holds exactly (measured 0.0), and against the f64 truth
# on random floats (measured 3.0e-5 on 0-255, 1.2e-7 on 0-1: a rounding of
# the sums, of the mean and of 2x - mean); the JAX package's f32 SAT is
# 1.7e-3 and 9.8e-6 from the truth on the same data, so it is not the
# reference for random floats
F255_TOL, F01_TOL = 1e-4, 1e-6


@pytest.mark.parametrize("op", ["box_blur", "sharpen"])
@pytest.mark.parametrize("radius", [1, 3, 0])
def test_float_box_blur_and_sharpen_equal_jax_where_jax_is_exact(op, radius):
    for shape in ((20, 30, 3), (33, 7, 1), (64, 47, 1)):
        for x in (_u8(shape, 15).astype(np.float32), _dyadic(shape, 15)):
            got = getattr(integral, op)(torch.from_numpy(x), radius).numpy()
            want = getattr(jax_integral, op)(jnp.asarray(x), radius)
            assert got.dtype == np.float32
            assert float(np.abs(got - np.asarray(want)).max()) <= 0.0


def _truth(op, x, radius):
    """f64 clamped-window mean (box blur) or ``2x - mean`` (sharpen)."""
    h, w = x.shape[:2]
    out = np.empty(x.shape, np.float64)
    for r in range(h):
        for c in range(w):
            win = x[max(0, r - radius):r + radius + 1,
                    max(0, c - radius):c + radius + 1].astype(np.float64)
            out[r, c] = win.mean(axis=(0, 1))
    return out if op == "box_blur" else 2.0 * x - out


@pytest.mark.parametrize("scale,tol", [(255.0, F255_TOL), (1.0, F01_TOL)],
                         ids=["0-255", "0-1"])
@pytest.mark.parametrize("op", ["box_blur", "sharpen"])
def test_float_box_blur_and_sharpen_within_bound_of_the_truth(op, scale, tol):
    rng = np.random.default_rng(16)
    for shape, radius in (((20, 30, 3), 1), ((64, 64, 1), 3),
                          ((33, 7, 1), 2)):
        x = (rng.random(shape, np.float32) * np.float32(scale)) \
            .astype(np.float32)
        got = getattr(integral, op)(torch.from_numpy(x), radius).numpy()
        assert float(np.abs(got - _truth(op, x, radius)).max()) <= tol


@pytest.mark.parametrize("shape,radius", [((20, 24), 2), ((2, 33, 17), 6),
                                          ((33, 7), 9), ((1, 9), 1),
                                          ((270, 260), 130)],
                         ids=["20x24-r2", "batch-r6", "33x7-r9", "1x9-r1",
                              "int-branch"])
def test_adaptive_mean_threshold_matches_jax(shape, radius):
    x = _u8(shape, 17)
    if shape == (270, 260):
        assert not integral.sums_fit_f32(270, 260, radius)
    for c in (5.0, -3.5, 0.0):
        got = binary.adaptive_mean_threshold(torch.from_numpy(x), radius,
                                             c).numpy()
        for i in np.ndindex(shape[:-2]):
            want = jax_binary.adaptive_mean_threshold(jnp.asarray(x[i]),
                                                      radius, c)
            assert np.array_equal(got[i], np.asarray(want))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_image_batch_threshold_adaptive_mean_matches_jax(channels):
    x = _u8((2, 25, 31, channels), 18)
    for radius, c in ((6, 5.0), (2, -1.0)):
        got = zp.ImageBatch(x, device="cpu").threshold_adaptive_mean(radius,
                                                                     c)
        want = jz.ImageBatch(x).threshold_adaptive_mean(radius, c)
        assert got.channels == 1
        assert np.array_equal(got.to_numpy(), want.to_numpy())
    for bad in (0, -2):
        with pytest.raises(ValueError, match="positive"):
            jz.ImageBatch(x).threshold_adaptive_mean(bad)
        with pytest.raises(ValueError, match="positive"):
            zp.ImageBatch(x, device="cpu").threshold_adaptive_mean(bad)
