"""Mean time of the program's ``resize_blur_oklab`` span in the traced
stretch: its own clock from the entry to the return, K1 queued."""

from benchmarks.program_spans import lay, mean


def read(run):
    laid = lay(run, "north_star")
    return None if laid is None else mean([t - s for s, t in laid.entries])
