"""Host time a request under the program's `serve_forward` span: the
host's time to queue the forward's launches, beside the device's
`forward_device_ms`."""

from benchmark import served_spans

LAYER = "serving entry and forward, host side"
UNIT = "ms/req"
MOVES = "serve_img_s"


def read(record):
    return served_spans.host_ms(record, "serve_forward")
