"""Share of the profiled sub-window in which no device event runs (the
union of the kernels', copies' and sets' intervals), from the profile
that records the CUDA activity alone and so leaves the host's pace as
it is unprofiled."""

LAYER = "device"
UNIT = "%"
MOVES = "serve_img_s"


def read(record):
    if not record.get("busy_us"):
        return None
    return 100.0 * (1.0 - record["busy_us"] / record["window_us"])
