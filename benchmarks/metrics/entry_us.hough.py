"""Mean time of the program's ``hough`` span in the traced stretch of the
lane_hough deployment: ``HoughTransform.lines_batch`` from its entry to
its return, the resize, the votes and the peaks queued, with the waits
for the edge list and the peak list. The spans are laid as
``entry_us.canny`` lays them; nothing is read where that reads nothing or
a request holds no ``hough`` span."""

from benchmarks.program_spans import mean
from benchmarks.run import load

lay = load("metrics", "entry_us.canny").lay


def read(run):
    laid = lay(run)
    if laid is None:
        return None
    spans = [t - s for s, t, name in laid.spans if name == "hough"]
    return mean(spans) if len(spans) == len(laid.entries) else None
