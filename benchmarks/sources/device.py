"""Input resident on the card: a ring of ``ring`` distinct request inputs
made on the device from the seed in one call, read in turn. The ring is
sized past the card's 50 MB L2, so no request finds its input in cache."""

from __future__ import annotations

import torch


class Ring:
    def __init__(self, shape, ring: int, seed: int, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        data = torch.randint(0, 256, (ring, *shape), generator=gen,
                             dtype=torch.uint8, device=device)
        self.data = data.unbind(0)  # views, so a request indexes a list

    def __len__(self) -> int:
        return len(self.data)

    def issue(self, adapter, cfg, i: int, span):
        return adapter.run_device(cfg, self.data[i % len(self.data)], span)

    def on_device(self, i: int):
        """Request ``i``'s input on the card, for the reference."""
        return self.data[i % len(self.data)]
