"""The int8 GEMM's share of its roofline: the useful multiply-adds of
the convs the kernel computed (each conv a range holds an int8 kernel
of; a region's range counts its quantized convs), from their shapes, at
the published int8 rate, or their bytes (int8 input and weights read
once, the bf16 output written once) at the memory peak, whichever
bounds each conv; over the device time of the kernels named below."""

from benchmark import flops

LAYER = "int8 GEMM"
UNIT = "%"
MOVES = "serve_img_s"
KERNELS = ("int8_gemm_kernel",)


def read(record):
    tr, peak = record.get("trace"), record.get("peaks")
    if not tr or not peak:
        return None
    model = record["model"]
    int8 = record["config"].get("int8") or {"min_ch": 128}
    quantized = model.int8_convs(int8["min_ch"])
    time_us, layers = 0.0, set()
    for name, s, t, scope in tr["kernels"]:
        if not any(k in name for k in KERNELS):
            continue
        time_us += t - s
        span = flops.scope_layers(scope) if scope else None
        if span:
            a, b = span
            layers |= {i for i in range(a, b + 1)
                       if i in quantized or a == b}
    if not time_us or not layers:
        return None
    batch = record["traffic"]["batch"]
    least = 0.0
    for i in layers:
        l = model.layers[i]
        least += max(2 * flops.conv_macs(l) * batch / peak["int8_ops_s"],
                     flops.conv_bytes(l, batch, 1, 1, 2)
                     / peak["hbm_bytes_s"])
    return 100.0 * least * tr["requests"] / (time_us / 1e6)
