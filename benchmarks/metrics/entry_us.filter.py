"""Mean time of the program's ``filter_chain`` span in the traced
stretch: its own clock from the entry to the return, the in-program twin
of the harness's ``launch`` span (``launch_us.filter``)."""

from benchmarks.program_spans import lay, mean


def read(run):
    laid = lay(run, "filter_fusion")
    return None if laid is None else mean([t - s for s, t in laid.entries])
