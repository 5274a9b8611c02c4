"""Device time a request outside the forward's ranges: the frames'
upload and normalisation, the decode, the top-k, the device NMS and the
triple's copy back."""

LAYER = "serving postprocess"
UNIT = "ms/req"
MOVES = "serve_img_s"


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    us = sum(t - s for _n, s, t, scope in tr["kernels"] if not scope)
    return us / 1e3 / tr["requests"] if us else None
