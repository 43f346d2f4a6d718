"""Photo-like u8 RGB frames resident on the card: a ring of ``ring``
distinct request inputs ``[B, H, W, 3]`` made on the device from the seed,
read in turn. Sized past the card's 50 MB L2, so no request finds its input
in cache.

A frame is a smooth scene with grain: a 28 x 37 grid of uniform values
shared by the three channels, mixed 0.8 / 0.2 with a grid of each
channel's own, upsampled bilinearly to H x W to give ``s`` in [0, 1];
then ``v = clamp(round(16 + 128 s^1.8 + n), 0, 255)`` with ``n`` uniform
integers in [-6, 6]. Its histogram is peaked and its highlights are
empty, as an under-exposed camera frame's are, so equalization moves
every value; its darkest values fall under CIELAB's linear branch.
Uniform random bytes would leave the equalization tables near the
identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GRID = (28, 37)
SHARED = 0.8
GAMMA = 1.8
BLACK, RANGE, GRAIN = 16.0, 128.0, 6


def frames(shape, gen, device):
    """``[B, H, W, 3]`` u8 frames from the generator ``gen``."""
    b, h, w, c = shape
    shared = torch.rand((b, 1) + GRID, generator=gen, device=device)
    own = torch.rand((b, c) + GRID, generator=gen, device=device)
    grid = SHARED * shared + (1 - SHARED) * own
    s = F.interpolate(grid, size=(h, w), mode="bilinear",
                      align_corners=True).clamp(0, 1)
    grain = torch.randint(-GRAIN, GRAIN + 1, (b, c, h, w), generator=gen,
                          device=device, dtype=torch.int16)
    v = torch.round(BLACK + RANGE * s ** GAMMA) + grain
    return v.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


class Ring:
    def __init__(self, shape, ring: int, seed: int, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.data = [frames(shape, gen, device) for _ in range(ring)]

    def __len__(self) -> int:
        return len(self.data)

    def issue(self, adapter, cfg, i: int, span):
        return adapter.run_device(cfg, self.data[i % len(self.data)], span)

    def on_device(self, i: int):
        """Request ``i``'s input on the card, for the reference."""
        return self.data[i % len(self.data)]
