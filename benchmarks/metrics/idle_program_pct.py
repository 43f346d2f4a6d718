"""The card's idle time in the traced stretch that lies under an open
span of the program, in percent of the stretch: of ``device_idle_pct``,
the part the program's own host work holds the card back, and so the most
a change on the program's side could win back."""

from benchmarks.program_spans import ENTRY, idle_under_spans_pct, lay


def read(run):
    config = run.cfg["name"]
    if config not in ENTRY:
        return None
    return idle_under_spans_pct(run, lay(run, config))
