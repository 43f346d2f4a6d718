"""Content-aware seam carving (reference: examples/src/seam_carving.zig,
whose dynamic-programming energy lives in the example itself; host numpy
here too)."""

import numpy as np

from zignal_tpu_torch.examples._common import load_input, parse, save, zignal


def _remove_vertical_seam(arr):
    h, w = arr.shape[:2]
    gray = (0.2126 * arr[..., 0] + 0.7152 * arr[..., 1]
            + 0.0722 * arr[..., 2]).astype(np.float64)
    gx = np.abs(np.diff(gray, axis=1, append=gray[:, -1:]))
    gy = np.abs(np.diff(gray, axis=0, append=gray[-1:, :]))
    cost = gx + gy
    for r in range(1, h):
        left = np.roll(cost[r - 1], 1)
        right = np.roll(cost[r - 1], -1)
        left[0] = np.inf
        right[-1] = np.inf
        cost[r] += np.minimum(np.minimum(left, cost[r - 1]), right)
    seam = np.zeros(h, dtype=int)
    seam[-1] = int(np.argmin(cost[-1]))
    for r in range(h - 2, -1, -1):
        lo = max(seam[r + 1] - 1, 0)
        hi = min(seam[r + 1] + 2, w)
        seam[r] = lo + int(np.argmin(cost[r, lo:hi]))
    mask = np.ones((h, w), bool)
    mask[np.arange(h), seam] = False
    return arr[mask].reshape(h, w - 1, arr.shape[2])


def main(argv=None):
    args = parse(argv, __doc__)
    arr = load_input(args, size=(192, 256)).to_numpy().copy()
    for _ in range(64):
        arr = _remove_vertical_seam(arr)
    save(args, zignal.Image.from_numpy(np.ascontiguousarray(arr),
                                       device=args.device),
         "seam_carved.png")


if __name__ == "__main__":
    main()
