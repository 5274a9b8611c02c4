"""Host time a request under the program's `serve_upload` span: the
frames from the host array to the device input (`torch.from_numpy`, the
copy to the card, the uint8 table lookup).  The copy waits for the
device's queue, so this holds the wait for the last request's work."""

from benchmark import served_spans

LAYER = "serving entry and forward, host side"
UNIT = "ms/req"
MOVES = "serve_img_s"


def read(record):
    return served_spans.host_ms(record, "serve_upload")
