"""Device time a request under the forward's ranges (`L###_kind`,
`L###-###_region`): the convs, their epilogues and the region kernel."""

LAYER = "forward: convs, epilogues, region"
UNIT = "ms/req"
MOVES = "serve_img_s"


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    us = sum(t - s for _n, s, t, scope in tr["kernels"] if scope)
    return us / 1e3 / tr["requests"] if us else None
