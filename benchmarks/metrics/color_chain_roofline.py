"""K3 in the colorspace deployment against the card's roofline: the least
time of its u8 sRGB -> f32 Lab route (``roofline_colorspace.k3_lab_bound``)
over the device time a request of K3's own kernels (by name) in the traced
stretch, in percent."""

KERNEL = "color_chain_kernel"


def kernel_ms(trace, mine: bool):
    """Device time a request of the stretch's kernels whose name holds
    ``KERNEL`` (``mine``) or does not; None where there is none."""
    total = sum(t - s for s, t, cat, name in trace.ops
                if cat == "kernel" and (KERNEL in name) == mine)
    if not trace.requests or total <= 0:
        return None
    return total / 1e3 / trace.requests


def read(run):
    if run.cfg["name"] != "colorspace" or run.trace is None:
        return None
    ms = kernel_ms(run.trace, True)
    return None if ms is None else 100 * run.adapter.bound_ms(
        run.cfg, run.batch) / ms
