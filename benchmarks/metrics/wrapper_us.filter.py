"""Mean time a ``filter_chain`` call spends in the K2 wrapper's stages
in the traced stretch: ``K2.check + K2.plan + K2.alloc + K2.params``
(program spans), the host work of ``ops/filter_chain.py`` ahead of the
launch."""

from benchmarks.program_spans import lay

STAGES = ("K2.check", "K2.plan", "K2.alloc", "K2.params")


def read(run):
    laid = lay(run, "filter_fusion")
    if laid is None:
        return None
    return sum(laid.inside_entries(STAGES)) / len(laid.entries)
