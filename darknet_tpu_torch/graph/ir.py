"""Typed graph IR for darknet `.cfg` networks.

The reference stores every layer in a single 437-field union struct
(`yolo_core.h:149-437`) with function-pointer dispatch.  Here each layer kind
is a frozen dataclass carrying only its static configuration plus inferred
shapes; the parameter arrays live in a separate list of dicts (see
`darknet_tpu_torch.nn.params`) and the forward is built from this IR (see
`darknet_tpu_torch.nn.emit`).  The port's copy of `darknet_tpu/graph/ir.py`.

Shape conventions: the IR records darknet-style (h, w, c) per layer —
channel-major bookkeeping identical to the reference so the printed layer
table and `.weights` layout match — while the runtime tensors are NHWC
(TPU-friendly, channels on the 128-lane minor dimension).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# --------------------------------------------------------------------------
# Enumerations (string-valued for readability; match cfg spellings)
# --------------------------------------------------------------------------

ACTIVATIONS = (
    "logistic", "swish", "mish", "normalize_channels",
    "normalize_channels_softmax", "normalize_channels_softmax_maxval",
    "loggy", "relu", "relu6", "elu", "selu", "gelu", "relie", "plse",
    "hardtan", "lhtan", "linear", "ramp", "leaky", "tanh", "stair",
)

IOU_LOSSES = ("mse", "iou", "giou", "diou", "ciou")
NMS_KINDS = ("greedynms", "diounms")
YOLO_POINTS = ("center", "left_top", "right_bottom")

LR_POLICIES = (
    "random", "poly", "constant", "step", "exp", "sigmoid", "steps", "sgdr",
)


def normalize_activation(s: str) -> str:
    """Map a cfg activation string to its canonical name.

    Unknown strings fall back to relu with a warning, matching
    `get_activation` (reference `activations.c:49-97`).
    """
    if s in ACTIVATIONS:
        return s
    import warnings

    warnings.warn(f"Couldn't find activation function {s}, going with ReLU")
    return "relu"


# --------------------------------------------------------------------------
# Net-level configuration ([net] section) — reference ParseNetOptions
# --------------------------------------------------------------------------


@dataclasses.dataclass
class NetConfig:
    # geometry
    h: int
    w: int
    c: int
    # batching: note the reference divides `batch` by `subdivisions` at parse
    # time (parser.cpp:929) — `batch` here is the per-step micro-batch and
    # `batch * subdiv` the optimizer batch.
    batch: int = 1
    subdiv: int = 1
    max_epoch: int = 0

    # optimizer
    lr: float = 1e-3
    lr_min: float = 1e-5
    momentum: float = 0.9
    decay: float = 1e-4
    policy: str = "constant"
    burn_in: int = 0
    power: float = 4.0
    step: int = 1
    scale: float = 1.0
    steps: tuple = ()
    scales: tuple = ()
    num_steps: int = 0
    gamma: float = 1.0
    sgdr_cycle: int = 0
    sgdr_mult: int = 2
    adam: bool = False
    B1: float = 0.9
    B2: float = 0.999
    eps: float = 1e-6
    loss_scale: float = 1.0

    # augmentation
    max_crop: int = 0
    min_crop: int = 0
    flip: bool = True
    blur: int = 0
    gaussian_noise: int = 0
    mixup: int = 0            # 0=off, 2=cutmix, 3=mosaic, 4=mosaic+cutmix
    label_smooth_eps: float = 0.0
    resize_step: int = 32
    angle: float = 0.0
    aspect: float = 1.0
    saturation: float = 1.0
    exposure: float = 1.0
    hue: float = 0.0

    # bookkeeping
    inputs: int = 0
    max_iter: int = 0          # set by the trainer: iter_per_epoch * max_epoch
    # diagnostics: print per-layer receptive fields in the layer table
    # (parser.cpp:1126-1315, quiet option `show_receptive_field`)
    show_receptive_field: bool = False

    @property
    def optimizer_batch(self) -> int:
        return self.batch * self.subdiv


# --------------------------------------------------------------------------
# Layer IR nodes
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LayerIR:
    """Base: common shape bookkeeping shared by every layer kind."""

    index: int = -1
    kind: str = ""
    # input dims (darknet order)
    h: int = 0
    w: int = 0
    c: int = 0
    inputs: int = 0
    # output dims
    out_h: int = 0
    out_w: int = 0
    out_c: int = 0
    outputs: int = 0
    # generic per-layer flags parsed for every section (parser.cpp:1360-1369)
    clip: float = 0.0
    onlyforward: bool = False
    # iteration threshold: the update applies only once dont_update < iter
    # (parser.cpp:1363, network_kernels.cu:231) — NOT a boolean
    dont_update: int = 0
    # multiplier: update skipped while burnin_update * net.burn_in > iter
    # (network_kernels.cu:228)
    burnin_update: int = 0
    stopbackward: bool = False
    train_only_bn: bool = False
    dontload: bool = False
    dontloadscales: bool = False
    learning_rate_scale: float = 1.0
    bflops: float = 0.0

    @property
    def out_shape_nhwc(self) -> tuple:
        return (self.out_h, self.out_w, self.out_c)

    def input_indices(self) -> list[int]:
        """Graph edges: indices of layers consumed besides the previous one."""
        return []


@dataclasses.dataclass
class ConvIR(LayerIR):
    kind: str = "convolutional"
    n: int = 1                   # filters
    groups: int = 1
    size: int = 1
    stride_x: int = 1
    stride_y: int = 1
    dilation: int = 1
    pad: int = 0                 # resolved padding (pad=1 -> size//2)
    activation: str = "logistic"
    batch_normalize: bool = False
    binary: bool = False
    xnor: bool = False
    antialiasing: int = 0        # 0=off, 1=3x3 binomial blur, 2=2x2 box blur
    blur_stride_x: int = 1       # original stride when antialiasing rewires
    blur_stride_y: int = 1
    share_index: Optional[int] = None  # absolute layer index of shared weights

    @property
    def nweights(self) -> int:
        return (self.c // self.groups) * self.n * self.size * self.size


@dataclasses.dataclass
class LocalIR(LayerIR):
    kind: str = "local"
    n: int = 1
    size: int = 1
    stride: int = 1
    pad: int = 0
    activation: str = "logistic"


@dataclasses.dataclass
class ConnectedIR(LayerIR):
    kind: str = "connected"
    activation: str = "logistic"
    batch_normalize: bool = False


@dataclasses.dataclass
class MaxpoolIR(LayerIR):
    kind: str = "maxpool"
    size: int = 1
    stride_x: int = 1
    stride_y: int = 1
    pad: int = 0                 # total padding budget (default size-1)
    maxpool_depth: bool = False
    out_channels: int = 1
    antialiasing: int = 0        # 0=off, 1=3x3 binomial blur, 2=2x2 box blur
    blur_stride_x: int = 1
    blur_stride_y: int = 1


@dataclasses.dataclass
class AvgpoolIR(LayerIR):
    kind: str = "avgpool"


@dataclasses.dataclass
class RouteIR(LayerIR):
    kind: str = "route"
    layers: tuple = ()
    groups: int = 1
    group_id: int = 0

    def input_indices(self) -> list[int]:
        return list(self.layers)


@dataclasses.dataclass
class ShortcutIR(LayerIR):
    kind: str = "shortcut"
    from_layer: int = -1
    activation: str = "linear"

    def input_indices(self) -> list[int]:
        return [self.from_layer]


@dataclasses.dataclass
class ScaleChannelsIR(LayerIR):
    kind: str = "scale_channels"
    from_layer: int = -1
    scale_wh: bool = False
    activation: str = "linear"

    def input_indices(self) -> list[int]:
        return [self.from_layer]


@dataclasses.dataclass
class UpsampleIR(LayerIR):
    kind: str = "upsample"
    stride: int = 2
    scale: float = 1.0
    reverse: bool = False   # cfg stride<0: block-sum downsample


@dataclasses.dataclass
class ReorgIR(LayerIR):
    kind: str = "reorg"          # cfg [reorg3d]
    stride: int = 1
    reverse: bool = False


@dataclasses.dataclass
class ReorgOldIR(LayerIR):
    kind: str = "reorg_old"      # cfg [reorg]
    stride: int = 1
    reverse: bool = False


@dataclasses.dataclass
class DropoutIR(LayerIR):
    kind: str = "dropout"
    probability: float = 0.2
    dropblock: bool = False
    dropblock_size_rel: float = 0.0
    dropblock_size_abs: int = 0


@dataclasses.dataclass
class BatchnormIR(LayerIR):
    kind: str = "batchnorm"


@dataclasses.dataclass
class ActivationIR(LayerIR):
    kind: str = "activation"
    activation: str = "linear"


@dataclasses.dataclass
class CropIR(LayerIR):
    kind: str = "crop"
    crop_height: int = 1
    crop_width: int = 1
    flip: bool = False
    angle: float = 0.0
    saturation: float = 1.0
    exposure: float = 1.0
    shift: float = 0.0
    noadjust: bool = False


@dataclasses.dataclass
class CostIR(LayerIR):
    kind: str = "cost"
    cost_type: str = "sse"       # sse | masked | smooth
    cost_scale: float = 1.0
    ratio: float = 0.0


@dataclasses.dataclass
class DetectionIR(LayerIR):
    """YOLOv1 head (reference detection_layer.cpp)."""

    kind: str = "detection"
    coords: int = 1
    classes: int = 1
    rescore: bool = False
    num: int = 1
    side: int = 7
    sqrt: bool = False
    max_boxes: int = 30
    coord_scale: float = 1.0
    forced: bool = False
    object_scale: float = 1.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    jitter: float = 0.2
    random: float = 0.0
    reorg: bool = False


@dataclasses.dataclass
class YoloIR(LayerIR):
    """YOLOv3/v4 head (reference yolo_layer.cpp)."""

    kind: str = "yolo"
    classes: int = 20
    total: int = 1               # total anchor count across all heads
    mask: tuple = ()             # anchor indices used by this head
    anchors: tuple = ()          # flattened (w0,h0,w1,h1,...) of ALL anchors
    max_boxes: int = 90
    label_smooth_eps: float = 0.0
    scale_x_y: float = 1.0
    max_delta: float = float("inf")
    iou_normalizer: float = 0.75
    cls_normalizer: float = 1.0
    iou_loss: str = "mse"
    iou_thresh_kind: str = "iou"
    beta_nms: float = 0.6
    nms_kind: str = "greedynms"
    jitter: float = 0.2
    focal_loss: bool = False
    ignore_thresh: float = 0.5
    truth_thresh: float = 1.0
    iou_thresh: float = 1.0
    random: float = 0.0
    classes_multipliers: Optional[tuple] = None
    class_map: Optional[tuple] = None   # cfg `map=` file: truth id remap

    @property
    def n(self) -> int:
        return len(self.mask)

    @property
    def truths(self) -> int:
        return self.max_boxes * 5


@dataclasses.dataclass
class GaussianYoloIR(YoloIR):
    """Gaussian-YOLO head: 8 box channels (mu/sigma per coord) + obj + cls."""

    kind: str = "gaussian_yolo"
    uc_normalizer: float = 1.0
    yolo_point: str = "center"

    @property
    def truths(self) -> int:
        return self.max_boxes * 5


@dataclasses.dataclass
class EmptyIR(LayerIR):
    kind: str = "empty"


# --------------------------------------------------------------------------
# Helpers
# --------------------------------------------------------------------------


def conv_out_hw(h: int, w: int, size: int, stride_y: int, stride_x: int,
                pad: int) -> tuple:
    """Reference ConvOutHeight/Width (convolutional_layer.cpp:87-95).

    Note: the reference formula deliberately ignores dilation; dilated convs
    in darknet keep the undilated output size by construction of their cfgs.
    """
    out_h = (h + 2 * pad - size) // stride_y + 1
    out_w = (w + 2 * pad - size) // stride_x + 1
    return out_h, out_w


def conv_bflops(nweights: int, out_h: int, out_w: int) -> float:
    """2 * nweights * out_h * out_w / 1e9 (convolutional_layer.cpp:714)."""
    return 2.0 * nweights * out_h * out_w / 1e9
