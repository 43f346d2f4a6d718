"""Mean time on the card of ORB's pyramid stage in the traced stretch of
the orb_stereo deployment: the program's ``orb.pyramid@device`` span, from
a CUDA event on the stream before K4's blur to one after the levels are
pasted into one plane, one a request (``device_spans.py``)."""

from benchmarks.device_spans import device_us


def read(run):
    return device_us(run, "orb_stereo", "orb", "orb.pyramid")
