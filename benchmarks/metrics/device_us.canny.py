"""Mean time on the card of Canny in the traced stretch of the lane_hough
deployment: the program's ``canny@device`` span, from a CUDA event before
``ops.edges.canny`` queues its front kernel to one after its hysteresis,
one a request; the adapter's f32 conversion lies before it
(``device_spans.py``)."""

from benchmarks.device_spans import device_us


def read(run):
    return device_us(run, "lane_hough", "canny", "canny")
