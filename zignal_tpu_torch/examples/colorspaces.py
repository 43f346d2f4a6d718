"""Colour space conversions (reference: examples/src/colorspaces.zig): a
hue strip through HSV, and round trips through Oklab, Lab and XYB on the
device."""

import numpy as np
import torch

from zignal_tpu_torch.color import convert_array
from zignal_tpu_torch.examples._common import load_input, parse, save, zignal


def main(argv=None):
    args = parse(argv, __doc__)
    w, h = 360, 48
    hsv = torch.zeros((h, w, 3), dtype=torch.float32, device=args.device)
    hsv[..., 0] = torch.linspace(0, 360, w + 1, device=args.device)[:-1]
    hsv[..., 1:] = 100.0
    rgb = convert_array(hsv, "hsv", "rgb")
    strip = (rgb * 255).to(torch.uint8).cpu().numpy()
    save(args, zignal.Image.from_numpy(strip, device=args.device),
         "hsv_hue_strip.png")

    img = load_input(args, size=(256, 256))
    arr = torch.from_numpy(img.to_numpy().astype(np.float32) / 255.0) \
        .to(args.device)
    for space in ("oklab", "lab", "xyb"):
        back = convert_array(convert_array(arr, "rgb", space), space, "rgb")
        u8 = torch.clamp(back * 255 + 0.5, 0, 255).to(torch.uint8)
        save(args, zignal.Image.from_numpy(u8.cpu().numpy(),
                                           device=args.device),
             f"roundtrip_{space}.png")
        err = float((back - arr).abs().max()) * 255
        print(f"{space}: roundtrip max err {err:.2f}/255")

    c = zignal.Rgb(255, 136, 0)
    print("Rgb(255,136,0) ->", c.to(zignal.Oklch), "|", c.to(zignal.Lab))


if __name__ == "__main__":
    main()
