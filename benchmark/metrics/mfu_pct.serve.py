"""The window's served images at the least time the card could take
for their convs at its published dense peaks (bf16 convs at the bf16
rate, int8 convs at the int8 rate), over the window's measured time."""

from benchmark import flops

LAYER = "whole step against the chip's peak"
UNIT = "%"
MOVES = "serve_img_s"


def read(record):
    peak = record.get("peaks")
    if not peak:
        return None
    int8 = record["config"].get("int8")
    model = record["model"]
    quantized = model.int8_convs(int8["min_ch"]) if int8 else ()
    w = record["window"]
    least = w["images"] * flops.forward_least_s(model, quantized, peak=peak)
    return 100.0 * least / w["seconds"]
