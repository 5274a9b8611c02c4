"""Share of the convs a request serves outside the region kernel whose
epilogue (bias, rounding, activation) ran in one pass on the card, as the
program counts them (`conv_epilogues_fused` of `conv_epilogues`).  None
where the program counts no conv epilogue."""

from benchmark import served_spans

LAYER = "forward: convs, epilogues, region"
UNIT = "%"
MOVES = "serve_img_s"


def read(record):
    total = served_spans.per_request(record, "conv_epilogues")
    if not total:
        return None
    return 100.0 * served_spans.per_request(
        record, "conv_epilogues_fused") / total
