"""Model zoo: programmatic generators for the canonical public YOLO cfgs.

The reference ships no cfg files; its dialect targets the standard
AlexeyAB/darknet model set (yolov3, yolov3-tiny, yolov4, yolov4-tiny,
Gaussian_yolov3).  These generators emit those architectures in the cfg
dialect the parser understands; every route/shortcut index is validated by
shape inference at build time (`tests/test_model_zoo.py`).

Usage:
    from darknet_tpu_torch.model_zoo import yolov4_cfg
    net = Network.from_cfg(yolov4_cfg(width=608, height=608))
"""

from __future__ import annotations

COCO_CLASSES = 80

_V3_ANCHORS = "10,13,  16,30,  33,23,  30,61,  62,45,  59,119,  116,90,  156,198,  373,326"
_V4_ANCHORS = "12,16, 19,36, 40,28, 36,75, 76,55, 72,146, 142,110, 192,243, 459,401"
_TINY_ANCHORS = "10,14,  23,27,  37,58,  81,82,  135,169,  344,319"


def _net(width, height, batch=64, subdiv=8, extra=""):
    return f"""[net]
batch={batch}
subdivisions={subdiv}
width={width}
height={height}
channels=3
momentum=0.949
decay=0.0005
angle=0
saturation=1.5
exposure=1.5
hue=.1
learning_rate=0.001
burn_in=1000
max_epoch=300
policy=steps
steps=0.8,0.9
scales=.1,.1
{extra}
"""


def _conv(filters, size, stride=1, act="mish", bn=True, extra=""):
    pad = "pad=1\n" if size > 1 else "pad=1\n"
    return (f"[convolutional]\n"
            + ("batch_normalize=1\n" if bn else "")
            + f"filters={filters}\nsize={size}\nstride={stride}\n{pad}"
            + f"activation={act}\n{extra}\n")


def _route(layers, groups=None, group_id=None):
    s = f"[route]\nlayers = {layers}\n"
    if groups is not None:
        s += f"groups={groups}\ngroup_id={group_id}\n"
    return s + "\n"


def _shortcut(frm, act="linear"):
    return f"[shortcut]\nfrom={frm}\nactivation={act}\n\n"


def _maxpool(size, stride):
    return f"[maxpool]\nsize={size}\nstride={stride}\n\n"


def _upsample(stride=2):
    return f"[upsample]\nstride={stride}\n\n"


def _yolo(mask, anchors, classes, num, scale_x_y=None, v4=False,
          gaussian=False):
    head = "[Gaussian_yolo]" if gaussian else "[yolo]"
    s = (f"{head}\nmask = {mask}\nanchors = {anchors}\n"
         f"classes={classes}\nnum={num}\njitter=.3\nignore_thresh = .7\n"
         f"truth_thresh = 1\nrandom=1\n")
    if scale_x_y is not None:
        s += f"scale_x_y = {scale_x_y}\n"
    if v4:
        s += ("iou_thresh=0.213\ncls_normalizer=1.0\niou_normalizer=0.07\n"
              "iou_loss=ciou\nnms_kind=greedynms\nbeta_nms=0.6\n"
              "max_delta=5\n")
    if gaussian:
        s += "iou_loss=mse\nuc_normalizer=1.0\n"
    return s + "\n"


# --------------------------------------------------------------------------
# YOLOv4 (CSPDarknet53 + SPP + PAN), 162 layers
# --------------------------------------------------------------------------


def _csp_block(filters, n_res, first=False):
    """One CSP downsample stage: down conv, split, res x n, merge."""
    half = filters // 2 if not first else filters
    s = _conv(filters, 3, 2)                  # downsample
    s += _conv(half, 1)                       # split path A (route -2 later)
    s += _route("-2")
    s += _conv(half, 1)                       # split path B
    for _ in range(n_res):
        s += _conv(filters // 2 if not first else filters // 2, 1)
        s += _conv(half, 3)
        s += _shortcut(-3)
    s += _conv(half, 1)
    # merge with split path A: A sits 4+3*n_res layers back
    s += _route(f"-1,-{3 * n_res + 4}")
    s += _conv(filters, 1)                    # transition
    return s


def yolov4_cfg(width: int = 608, height: int = 608,
               classes: int = COCO_CLASSES, batch: int = 64,
               subdiv: int = 8) -> str:
    f = 3 * (classes + 5)
    s = _net(width, height, batch, subdiv, extra="mosaic=1\nletter_box=0")
    # backbone (mish)
    s += _conv(32, 3)                                     # 0
    s += _csp_block(64, 1, first=True)                    # 1-10
    s += _csp_block(128, 2)                               # 11-23
    s += _csp_block(256, 8)                               # 24-54 (54 = P3)
    s += _csp_block(512, 8)                               # 55-85 (85 = P4)
    s += _csp_block(1024, 4)                              # 86-104 (104 = P5)
    # head (leaky): SPP
    s += _conv(512, 1, act="leaky")                       # 105
    s += _conv(1024, 3, act="leaky")                      # 106
    s += _conv(512, 1, act="leaky")                       # 107
    s += _maxpool(5, 1)                                   # 108
    s += _route("-2")                                     # 109
    s += _maxpool(9, 1)                                   # 110
    s += _route("-4")                                     # 111
    s += _maxpool(13, 1)                                  # 112
    s += _route("-1,-3,-5,-6")                            # 113
    s += _conv(512, 1, act="leaky")                       # 114
    s += _conv(1024, 3, act="leaky")                      # 115
    s += _conv(512, 1, act="leaky")                       # 116
    # PAN up to P4
    s += _conv(256, 1, act="leaky")                       # 117
    s += _upsample()                                      # 118
    s += _route("85")                                     # 119
    s += _conv(256, 1, act="leaky")                       # 120
    s += _route("-1,-3")                                  # 121
    for _ in range(2):                                    # 122-125
        s += _conv(256, 1, act="leaky")
        s += _conv(512, 3, act="leaky")
    s += _conv(256, 1, act="leaky")                       # 126
    # PAN up to P3
    s += _conv(128, 1, act="leaky")                       # 127
    s += _upsample()                                      # 128
    s += _route("54")                                     # 129
    s += _conv(128, 1, act="leaky")                       # 130
    s += _route("-1,-3")                                  # 131
    for _ in range(2):                                    # 132-135
        s += _conv(128, 1, act="leaky")
        s += _conv(256, 3, act="leaky")
    s += _conv(128, 1, act="leaky")                       # 136
    # P3 head
    s += _conv(256, 3, act="leaky")                       # 137
    s += _conv(f, 1, act="linear", bn=False)              # 138
    s += _yolo("0,1,2", _V4_ANCHORS, classes, 9, "1.2", v4=True)   # 139
    # down to P4
    s += _route("-4")                                     # 140 (=136)
    s += _conv(256, 3, 2, act="leaky")                    # 141
    s += _route("-1,-16")                                 # 142 (=126)
    for _ in range(2):                                    # 143-146
        s += _conv(256, 1, act="leaky")
        s += _conv(512, 3, act="leaky")
    s += _conv(256, 1, act="leaky")                       # 147
    s += _conv(512, 3, act="leaky")                       # 148
    s += _conv(f, 1, act="linear", bn=False)              # 149
    s += _yolo("3,4,5", _V4_ANCHORS, classes, 9, "1.1", v4=True)   # 150
    # down to P5
    s += _route("-4")                                     # 151 (=147)
    s += _conv(512, 3, 2, act="leaky")                    # 152
    s += _route("-1,-37")                                 # 153 (=116)
    for _ in range(2):                                    # 154-157
        s += _conv(512, 1, act="leaky")
        s += _conv(1024, 3, act="leaky")
    s += _conv(512, 1, act="leaky")                       # 158
    s += _conv(1024, 3, act="leaky")                      # 159
    s += _conv(f, 1, act="linear", bn=False)              # 160
    s += _yolo("6,7,8", _V4_ANCHORS, classes, 9, "1.05", v4=True)  # 161
    return s


# --------------------------------------------------------------------------
# YOLOv3 (Darknet53 + FPN), 107 layers; Gaussian variant swaps the heads
# --------------------------------------------------------------------------


def yolov3_cfg(width: int = 416, height: int = 416,
               classes: int = COCO_CLASSES, gaussian: bool = False,
               batch: int = 64, subdiv: int = 8,
               spp: bool = False) -> str:
    per = (classes + 9) if gaussian else (classes + 5)
    f = 3 * per
    s = _net(width, height, batch, subdiv)
    s += _conv(32, 3, act="leaky")                        # 0

    def res_stage(filters, n_res):
        t = _conv(filters, 3, 2, act="leaky")
        for _ in range(n_res):
            t += _conv(filters // 2, 1, act="leaky")
            t += _conv(filters, 3, act="leaky")
            t += _shortcut(-3)
        return t

    s += res_stage(64, 1)                                 # 1-4
    s += res_stage(128, 2)                                # 5-11
    s += res_stage(256, 8)                                # 12-36 (36 = P3)
    s += res_stage(512, 8)                                # 37-61 (61 = P4)
    s += res_stage(1024, 4)                               # 62-74
    # head P5
    s += _conv(512, 1, act="leaky")                       # 75
    s += _conv(1024, 3, act="leaky")                      # 76
    s += _conv(512, 1, act="leaky")                       # 77
    if spp:
        # classic yolov3-spp block: parallel maxpools 5/9/13 + concat
        s += "[maxpool]\nstride=1\nsize=5\n\n"            # 78
        s += _route("-2")                                 # 79
        s += "[maxpool]\nstride=1\nsize=9\n\n"            # 80
        s += _route("-4")                                 # 81
        s += "[maxpool]\nstride=1\nsize=13\n\n"           # 82
        s += _route("-1,-3,-5,-6")                        # 83
        s += _conv(512, 1, act="leaky")
    s += _conv(1024, 3, act="leaky")
    s += _conv(512, 1, act="leaky")                       # 79 / 86
    s += _conv(1024, 3, act="leaky")                      # 80
    s += _conv(f, 1, act="linear", bn=False)              # 81
    s += _yolo("6,7,8", _V3_ANCHORS, classes, 9, gaussian=gaussian)  # 82
    s += _route("-4")                                     # 83 (=79)
    s += _conv(256, 1, act="leaky")                       # 84
    s += _upsample()                                      # 85
    s += _route("-1, 61")                                 # 86
    for _ in range(2):                                    # 87-90
        s += _conv(256, 1, act="leaky")
        s += _conv(512, 3, act="leaky")
    s += _conv(256, 1, act="leaky")                       # 91
    s += _conv(512, 3, act="leaky")                       # 92
    s += _conv(f, 1, act="linear", bn=False)              # 93
    s += _yolo("3,4,5", _V3_ANCHORS, classes, 9, gaussian=gaussian)  # 94
    s += _route("-4")                                     # 95 (=91)
    s += _conv(128, 1, act="leaky")                       # 96
    s += _upsample()                                      # 97
    s += _route("-1, 36")                                 # 98
    for _ in range(2):                                    # 99-102
        s += _conv(128, 1, act="leaky")
        s += _conv(256, 3, act="leaky")
    s += _conv(128, 1, act="leaky")                       # 103
    s += _conv(256, 3, act="leaky")                       # 104
    s += _conv(f, 1, act="linear", bn=False)              # 105
    s += _yolo("0,1,2", _V3_ANCHORS, classes, 9, gaussian=gaussian)  # 106
    return s


def gaussian_yolov3_cfg(width: int = 416, height: int = 416,
                        classes: int = COCO_CLASSES, **kw) -> str:
    return yolov3_cfg(width, height, classes, gaussian=True, **kw)


# --------------------------------------------------------------------------
# YOLOv4-tiny (CSP-tiny), 38 layers
# --------------------------------------------------------------------------


def yolov4_tiny_cfg(width: int = 416, height: int = 416,
                    classes: int = COCO_CLASSES, batch: int = 64,
                    subdiv: int = 1) -> str:
    f = 3 * (classes + 5)
    s = _net(width, height, batch, subdiv)
    s += _conv(32, 3, 2, act="leaky")                     # 0
    s += _conv(64, 3, 2, act="leaky")                     # 1

    def tiny_csp(filters):
        t = _conv(filters, 3, act="leaky")                # i
        t += _route("-1", groups=2, group_id=1)           # i+1
        t += _conv(filters // 2, 3, act="leaky")          # i+2
        t += _conv(filters // 2, 3, act="leaky")          # i+3
        t += _route("-1,-2")                              # i+4
        t += _conv(filters, 1, act="leaky")               # i+5
        t += _route("-6,-1")                              # i+6
        t += _maxpool(2, 2)                               # i+7
        return t

    s += tiny_csp(64)                                     # 2-9
    s += tiny_csp(128)                                    # 10-17
    s += tiny_csp(256)                                    # 18-25
    s += _conv(512, 3, act="leaky")                       # 26
    s += _conv(256, 1, act="leaky")                       # 27
    s += _conv(512, 3, act="leaky")                       # 28
    s += _conv(f, 1, act="linear", bn=False)              # 29
    s += _yolo("3,4,5", _TINY_ANCHORS, classes, 6, "1.05")  # 30
    s += _route("-4")                                     # 31 (=27)
    s += _conv(128, 1, act="leaky")                       # 32
    s += _upsample()                                      # 33
    s += _route("-1, 23")                                 # 34
    s += _conv(256, 3, act="leaky")                       # 35
    s += _conv(f, 1, act="linear", bn=False)              # 36
    s += _yolo("1,2,3", _TINY_ANCHORS, classes, 6, "1.05")  # 37
    return s


def yolov3_tiny_cfg(width: int = 416, height: int = 416,
                    classes: int = COCO_CLASSES) -> str:
    """yolov3-tiny — see tests/fixtures/yolov3-tiny.cfg for the canonical
    80-class file; this generator parameterizes width/classes."""
    f = 3 * (classes + 5)
    s = _net(width, height, batch=1, subdiv=1)
    for filters in (16, 32, 64, 128, 256):
        s += _conv(filters, 3, act="leaky")
        s += _maxpool(2, 2)
    s += _conv(512, 3, act="leaky")
    s += _maxpool(2, 1)
    s += _conv(1024, 3, act="leaky")
    s += _conv(256, 1, act="leaky")                       # 13
    s += _conv(512, 3, act="leaky")                       # 14
    s += _conv(f, 1, act="linear", bn=False)              # 15
    s += _yolo("3,4,5", _TINY_ANCHORS, classes, 6)        # 16
    s += _route("-4")                                     # 17 (=13)
    s += _conv(128, 1, act="leaky")                       # 18
    s += _upsample()                                      # 19
    s += _route("-1, 8")                                  # 20
    s += _conv(256, 3, act="leaky")                       # 21
    s += _conv(f, 1, act="linear", bn=False)              # 22
    s += _yolo("0,1,2", _TINY_ANCHORS, classes, 6)        # 23
    return s


MODELS = {
    "yolov3": yolov3_cfg,
    "yolov3-tiny": yolov3_tiny_cfg,
    "yolov4": yolov4_cfg,
    "yolov4-tiny": yolov4_tiny_cfg,
    "gaussian_yolov3": gaussian_yolov3_cfg,
}


def yolov3_spp_cfg(width: int = 416, height: int = 416,
                   classes: int = COCO_CLASSES, **kw) -> str:
    """Classic yolov3-spp: darknet53 + the 5/9/13 SPP block at P5."""
    return yolov3_cfg(width, height, classes, spp=True, **kw)
