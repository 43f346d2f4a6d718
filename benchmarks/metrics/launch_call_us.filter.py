"""Mean time of the program's ``launch`` span within ``filter_chain``
calls in the traced stretch: the current device and stream looked up and
the ctypes call that returns once K2 is queued (``ops/_build.launch``)."""

from benchmarks.program_spans import lay, mean


def read(run):
    laid = lay(run, "filter_fusion")
    return None if laid is None else mean(laid.inside_entries(("launch",)))
