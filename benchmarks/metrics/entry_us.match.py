"""Mean time of the program's ``match`` span in the traced stretch of the
orb_stereo deployment: ``features.matcher.match_tensors`` from its entry
to its return, the distances, the argmins and the cross-check queued.
The spans are laid as ``entry_us.orb`` lays them; nothing is read where
that reads nothing or a request holds no ``match`` span."""

from benchmarks.program_spans import mean
from benchmarks.run import load

lay = load("metrics", "entry_us.orb").lay


def read(run):
    laid = lay(run)
    if laid is None:
        return None
    spans = [t - s for s, t, name in laid.spans if name == "match"]
    return mean(spans) if len(spans) == len(laid.entries) else None
