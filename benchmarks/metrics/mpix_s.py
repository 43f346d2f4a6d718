"""Input pixels of every request completed in the window, in millions,
over the window's seconds (host clock, first issue to last completion)."""


def read(run):
    return run.completed * run.pixels / run.window_s / 1e6
