"""The equalization of the colorspace deployment against the card's
roofline: its least time (``roofline_colorspace.equalize_bound``) over the
device time a request of the stretch's kernels other than K3's (the
histograms, tables and lookup), in percent."""

from benchmarks.run import load

kernel_ms = load("metrics", "color_chain_roofline").kernel_ms


def read(run):
    if run.cfg["name"] != "colorspace" or run.trace is None:
        return None
    ms = kernel_ms(run.trace, False)
    return None if ms is None else 100 * run.adapter.equalize_bound_ms(
        run.cfg, run.batch) / ms
