"""Mean time on the card of ORB's describe stage in the traced stretch of
the orb_stereo deployment: the program's ``orb.describe@device`` span, the
describe kernel's angles, BRIEF bits and rows, one a request
(``device_spans.py``)."""

from benchmarks.device_spans import device_us


def read(run):
    return device_us(run, "orb_stereo", "orb", "orb.describe")
