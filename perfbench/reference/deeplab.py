"""Plain DeepLabV3 on a dilated ResNet-D, in float32 PyTorch.

The benchmark's own reference: written from the architecture (DeepLabV3,
arXiv:1706.05587, as the DCFP repository builds it: a deep 3-conv stem,
bottlenecks with output-stride-8 dilations and a multi-grid layer4, ASPP
with an image-pool branch, a 3-conv classifier and an optional
deep-supervision head on layer3), with no kernel, graph interpreter or
cache.  It imports nothing of the measured program.

Parameters are plain dicts keyed by the module paths that the DCFP
repository and its ports share (``backbone.layer1.0.conv1``): a conv
holds ``kernel`` (OIHW) and maybe ``bias``, a BN ``scale`` and ``bias``,
and its running statistics ``mean`` and ``var`` sit in a second dict.
Widths come from a configuration's ``channel_cfg``; a layer it does not
name keeps its unpruned width.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
ASPP_DILATIONS = (12, 24, 36)  # output stride 8
DEEPSUP_DROPOUT = 0.1


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    stride: int = 1
    dilation: int = 1
    bias: bool = False

    @property
    def padding(self) -> int:
        return self.dilation * (self.k // 2)


def _widths(desc: dict):
    cfg = desc.get("channel_cfg", {})

    def out(name, default):
        return cfg.get(name, {}).get("out_channels", default)
    return out


def convs(desc: dict) -> List[Conv]:
    """Every conv of the model, in forward order, at the configuration's
    widths; each conv but the classifiers is followed by the BN named in
    :func:`bn_of`."""
    out = _widths(desc)
    bp = desc["backbone_para"]
    if bp.get("os", 8) != 8:
        raise NotImplementedError("only output stride 8 is described")
    layers = []

    def conv(name, cin, cout, k, stride=1, dilation=1, bias=False):
        c = Conv(name, cin, out(name, cout), k, stride, dilation, bias)
        layers.append(c)
        return c.cout

    inplanes = bp.get("inplanes", 128)
    c = conv("backbone.conv1.0", 3, 64, 3, 2)
    c = conv("backbone.conv1.3", c, 64, 3)
    c = conv("backbone.conv1.6", c, inplanes, 3)
    strides, dilations = (1, 2, 1, 1), (1, 1, 2, 4)
    mg = bp.get("mg_unit", [1, 2, 4])
    for s, n in enumerate(STAGES[desc["backbone"]]):
        planes = 64 * 2 ** s
        for i in range(len(mg) if s == 3 else n):
            p = f"backbone.layer{s + 1}.{i}"
            d = dilations[s] * (mg[i] if s == 3 else 1)
            stride = strides[s] if i == 0 else 1
            x = c
            m = conv(f"{p}.conv1", x, planes, 1)
            m = conv(f"{p}.conv2", m, planes, 3, stride, d)
            c = conv(f"{p}.conv3", m, planes * 4, 1)
            if i == 0:
                conv(f"{p}.downsample.0", x, planes * 4, 1, stride)
        if s == 2:
            layer3 = c
    x = c
    branches = [conv("aspp.aspp1.atrous_conv", x, 256, 1)]
    for j, d in enumerate(ASPP_DILATIONS, start=2):
        branches.append(conv(f"aspp.aspp{j}.atrous_conv", x, 256, 3, 1, d))
    branches.append(conv("aspp.global_avg_pool.1", x, 256, 1))
    c = conv("aspp.conv1", sum(branches), 512, 1)
    c = conv("last_conv.0", c, 256, 3)
    c = conv("last_conv.3", c, 256, 3)
    conv("last_conv.6", c, desc["num_classes"], 1, bias=True)
    if desc.get("deepsup"):
        c = conv("conv_deepsup.0", layer3, 512, 3)
        conv("conv_deepsup.4", c, desc["num_classes"], 1, bias=True)
    return layers


CLASSIFIERS = ("last_conv.6", "conv_deepsup.4")


def bn_of(conv_name: str) -> Optional[str]:
    """The BN after a conv (``None`` after a classifier)."""
    if conv_name in CLASSIFIERS:
        return None
    head, _, tail = conv_name.rpartition(".")
    if conv_name.startswith("backbone.conv1."):
        return "backbone.bn1" if tail == "6" else f"{head}.{int(tail) + 1}"
    if tail.startswith("conv") and ".layer" in conv_name:
        return f"{head}.bn{tail[4:]}"
    if tail == "0" and head.endswith("downsample"):
        return f"{head}.1"
    if tail == "atrous_conv":
        return f"{head}.bn"
    if conv_name == "aspp.global_avg_pool.1":
        return "aspp.global_avg_pool.2"
    if conv_name == "aspp.conv1":
        return "aspp.bn1"
    if head in ("last_conv", "conv_deepsup"):
        return f"{head}.{int(tail) + 1}"
    raise KeyError(conv_name)


IGNORE_PRUNE = ("aspp.bn1", "backbone.layer4.2.bn3")


def prunable_bns(desc: dict) -> List[str]:
    """The BNs whose scale DCFP scores (EIC), in forward order."""
    return [b for b in (bn_of(c.name) for c in convs(desc))
            if b is not None and b not in IGNORE_PRUNE]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

class _Net:
    def __init__(self, params, state, train: bool):
        self.p, self.s, self.train = params, state, train
        self.new_state: Dict[str, Dict[str, torch.Tensor]] = {}

    def conv(self, x, c: Conv):
        p = self.p[c.name]
        return F.conv2d(x, p["kernel"], p.get("bias"), c.stride, c.padding,
                        c.dilation)

    def bn(self, x, name):
        p, s = self.p[name], self.s[name]
        if not self.train:
            return F.batch_norm(x, s["mean"], s["var"], p["scale"],
                                p["bias"], False, 0.0, BN_EPS)
        mean, var = s["mean"].clone(), s["var"].clone()
        y = F.batch_norm(x, mean, var, p["scale"], p["bias"], True,
                         BN_MOMENTUM, BN_EPS)
        self.new_state[name] = {"mean": mean, "var": var}
        return y

    def cbr(self, x, c: Conv, relu=True):
        y = self.bn(self.conv(x, c), bn_of(c.name))
        return F.relu(y) if relu else y


def forward(desc: dict, params, state, image: torch.Tensor, *,
            train: bool = False, deepsup_keep: Optional[torch.Tensor] = None
            ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """``image`` NCHW float32.  Returns ({"pred": low-res logits,
    "deepsup": low-res logits when the model has the head}, new BN
    running statistics in train mode).  ``deepsup_keep`` (N, C, 1, 1)
    bool: the spatial-dropout mask of the deep-supervision head (train
    mode; ``None`` runs no dropout)."""
    layers = {c.name: c for c in convs(desc)}
    net = _Net(params, state, train)
    x = net.cbr(image, layers["backbone.conv1.0"])
    x = net.cbr(x, layers["backbone.conv1.3"])
    x = net.cbr(x, layers["backbone.conv1.6"])
    x = F.max_pool2d(x, 3, 2, 1)
    mg = desc["backbone_para"].get("mg_unit", [1, 2, 4])
    layer3 = None
    for s, n in enumerate(STAGES[desc["backbone"]]):
        for i in range(len(mg) if s == 3 else n):
            p = f"backbone.layer{s + 1}.{i}"
            m = net.cbr(x, layers[f"{p}.conv1"])
            m = net.cbr(m, layers[f"{p}.conv2"])
            m = net.cbr(m, layers[f"{p}.conv3"], relu=False)
            if i == 0:
                x = net.cbr(x, layers[f"{p}.downsample.0"], relu=False)
            x = F.relu(m + x)
        if s == 2:
            layer3 = x
    hw = x.shape[-2:]
    branches = [net.cbr(x, layers["aspp.aspp1.atrous_conv"])]
    for j in range(2, 2 + len(ASPP_DILATIONS)):
        branches.append(net.cbr(x, layers[f"aspp.aspp{j}.atrous_conv"]))
    g = x.mean(dim=(2, 3), keepdim=True)
    g = net.cbr(g, layers["aspp.global_avg_pool.1"])
    branches.append(g.expand(-1, -1, hw[0], hw[1]))  # bilinear from 1x1
    y = net.cbr(torch.cat(branches, 1), layers["aspp.conv1"])
    y = net.cbr(y, layers["last_conv.0"])
    y = net.cbr(y, layers["last_conv.3"])
    out = {"pred": net.conv(y, layers["last_conv.6"])}
    if desc.get("deepsup"):
        d = net.cbr(layer3, layers["conv_deepsup.0"])
        if train and deepsup_keep is not None:
            d = torch.where(deepsup_keep, d / (1.0 - DEEPSUP_DROPOUT), 0.0)
        out["deepsup"] = net.conv(d, layers["conv_deepsup.4"])
    return out, net.new_state


def upsample(logits: torch.Tensor, hw, align_corners: bool) -> torch.Tensor:
    """Bilinear resize of NCHW logits to ``hw`` in float32."""
    return F.interpolate(logits.float(), size=tuple(hw), mode="bilinear",
                         align_corners=align_corners)
