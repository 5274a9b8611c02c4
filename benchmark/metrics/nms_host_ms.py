"""Host time a request under the program's `serve_nms` span: the device
NMS's share of the request's latency, since it ends on a flag read."""

from benchmark import served_spans

LAYER = "serving postprocess"
UNIT = "ms/req"
MOVES = "serve_img_s"


def read(record):
    return served_spans.host_ms(record, "serve_nms")
