"""Mean time on the card of the Hough stage in the traced stretch of the
lane_hough deployment: the program's ``hough@device`` span, from a CUDA
event before ``HoughTransform.lines_batch`` queues its votes to one
after its lines, one a request (``device_spans.py``)."""

from benchmarks.device_spans import device_us


def read(run):
    return device_us(run, "lane_hough", "canny", "hough")
