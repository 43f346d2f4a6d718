"""Mean time on the card of the stereo match in the traced stretch of the
orb_stereo deployment: the program's ``match@device`` span, from a CUDA
event before ``features.matcher.match_tensors`` queues its Hamming
distances to one after its argmins and cross-check, one a request
(``device_spans.py``)."""

from benchmarks.device_spans import device_us


def read(run):
    return device_us(run, "orb_stereo", "orb", "match")
