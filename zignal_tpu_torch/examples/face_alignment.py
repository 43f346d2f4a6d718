"""Face alignment by a 5-landmark similarity fit (reference:
examples/src/face_alignment.zig).

The reference aligns a face to dlib's canonical 5 landmarks (eye corners
and nose tip, blog.dlib.net 2017-09) by fitting a SimilarityTransform and
backward-sampling the output chip with bilinear interpolation and a zero
border. With no face detector here, the demo draws a synthetic rotated
face with known landmark positions and recovers the upright chip.
"""

import numpy as np

from zignal_tpu_torch.enums import BorderMode, Interpolation
from zignal_tpu_torch.examples._common import parse, save, zignal
from zignal_tpu_torch.ops.warp import sample

# dlib's canonical aligned landmarks (normalized): left-eye outer, left-eye
# inner, right-eye outer, right-eye inner, nose tip (face_alignment.zig:47-53)
DLIB_CANONICAL = [
    (0.8595674595992, 0.2134981538014),
    (0.6460604764104, 0.2289674387677),
    (0.1205750620789, 0.2137274526848),
    (0.3340850613712, 0.2290642403242),
    (0.4901123135679, 0.6277975316475),
]


def extract_aligned_face(image, landmarks, side: int, padding: float = 0.25,
                         blurring: int = 0):
    """The aligned square face chip (face_alignment.zig extractAlignedFace);
    ``landmarks``: the 5 points in pixels, dlib's order; ``blurring`` > 0:
    box blur radius, < 0: sharpen radius."""
    from_points = [((padding + x) / (2 * padding + 1) * side,
                    (padding + y) / (2 * padding + 1) * side)
                   for x, y in DLIB_CANONICAL]
    transform = zignal.SimilarityTransform(from_points, landmarks)
    ys, xs = np.meshgrid(np.arange(side, dtype=np.float32),
                         np.arange(side, dtype=np.float32), indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel()], axis=-1)
    src = np.asarray(transform.project(pts), dtype=np.float32)
    out = sample(image._device(), src[:, 0].reshape(side, side),
                 src[:, 1].reshape(side, side), Interpolation.BILINEAR,
                 BorderMode.ZERO)
    chip = zignal.Image.from_numpy(out.cpu().numpy(), device=out.device)
    if blurring > 0:
        chip = chip.box_blur(blurring)
    elif blurring < 0:
        chip = chip.sharpen(-blurring)
    return chip


def synthetic_face(device, size=320, angle=0.35):
    """A cartoon face rotated by ``angle`` and its 5 landmark pixels."""
    img = zignal.Image(size, size, (24, 28, 40), dtype=zignal.Rgb,
                       device=device)
    canvas = img.canvas()
    c = size / 2
    canvas.fill_circle((c, c), size * 0.36, (224, 180, 150))
    lm = {
        "le_out": (c + size * 0.22, c - size * 0.10),
        "le_in": (c + size * 0.08, c - size * 0.10),
        "re_out": (c - size * 0.22, c - size * 0.10),
        "re_in": (c - size * 0.08, c - size * 0.10),
        "nose": (c, c + size * 0.10),
    }
    for key in ("le_in", "le_out", "re_in", "re_out"):
        canvas.fill_circle(lm[key], size * 0.015, (30, 30, 30))
    canvas.fill_circle(lm["nose"], size * 0.02, (180, 120, 100))
    canvas.draw_line((c - size * 0.1, c + size * 0.22),
                     (c + size * 0.1, c + size * 0.22), (120, 60, 60), 3)
    rotated = img.rotate(angle)
    # rotate() grows the frame: map the landmarks through the same rotation
    rr, rc = rotated.rows, rotated.cols
    ca, sa = np.cos(angle), np.sin(angle)
    pts = {k: (rc / 2 + (x - c) * ca - (y - c) * sa,
               rr / 2 + (x - c) * sa + (y - c) * ca)
           for k, (x, y) in lm.items()}
    return rotated, [pts[k] for k in ("le_out", "le_in", "re_out", "re_in",
                                      "nose")]


def main(argv=None):
    args = parse(argv, __doc__)
    face, landmarks = synthetic_face(args.device)
    save(args, face, "face_input.png")
    for blur, name in ((0, "face_aligned.png"), (2, "face_aligned_blur.png"),
                       (-2, "face_aligned_sharp.png")):
        save(args, extract_aligned_face(face, landmarks, side=128,
                                        blurring=blur), name)


if __name__ == "__main__":
    main()
