"""Times a request makes the host wait for the device's queue, as the
program counts them (`host_syncs`): the frames' copy to the card, the
anchors' copies in the decode, and the NMS loop's flag reads (before
each round and after the last, the first read twice)."""

from benchmark import served_spans

LAYER = "serving entry and forward, host side"
UNIT = "syncs/req"
MOVES = "serve_img_s"


def read(record):
    return served_spans.per_request(record, "host_syncs")
