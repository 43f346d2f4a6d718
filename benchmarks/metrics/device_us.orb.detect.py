"""Mean time on the card of ORB's detect stage in the traced stretch of
the orb_stereo deployment: the program's ``orb.detect@device`` span, the
detect kernel's FAST, NMS and Harris over the plane, one a request
(``device_spans.py``)."""

from benchmarks.device_spans import device_us


def read(run):
    return device_us(run, "orb_stereo", "orb", "orb.detect")
