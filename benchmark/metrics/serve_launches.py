"""Kernel launch calls a request: the runtime's launch calls in the
profiled sub-window over its requests (an exact count)."""

LAYER = "serving entry and forward, host side"
UNIT = "launches/req"
MOVES = "serve_img_s"


def read(record):
    tr = record.get("trace")
    if not tr or not tr["launches"]:
        return None
    return tr["launches"] / tr["requests"]
