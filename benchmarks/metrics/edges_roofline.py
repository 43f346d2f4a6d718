"""The lane_hough request against the card's roofline: its least time
(``roofline_edges.request_bound``) over the device time a request of all
the kernels the traced requests launched, in percent, so that it reads
the same work whatever kernels implement it."""


def read(run):
    if run.cfg["name"] != "lane_hough" or run.trace is None:
        return None
    return run.trace.roofline_pct(run.adapter.bound_ms(run.cfg, run.batch))
