"""Mean time on the card of ORB's select stage in the traced stretch of
the orb_stereo deployment: the program's ``orb.select@device`` span, each
level's sort of its candidates and the best kept, one a request
(``device_spans.py``)."""

from benchmarks.device_spans import device_us


def read(run):
    return device_us(run, "orb_stereo", "orb", "orb.select")
