"""The device NMS's rounds a request, as the program counts them
(`nms_rounds`): as many as the longest suppression chain of the batch."""

from benchmark import served_spans

LAYER = "serving postprocess"
UNIT = "rounds/req"
MOVES = "serve_img_s"


def read(record):
    return served_spans.per_request(record, "nms_rounds")
