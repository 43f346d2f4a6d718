"""The north star's request against the card's roofline: the least time
its work could take (``roofline.k1_bound``) over the device time of all
the kernels the traced requests launched, in percent."""


def read(run):
    if run.cfg["name"] != "north_star" or run.trace is None:
        return None
    return run.trace.roofline_pct(run.adapter.bound_ms(run.cfg, run.batch))
