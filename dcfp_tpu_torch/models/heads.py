"""Segmentation heads: deeplabv3 / deeplabv3p / psp / simple (FCN).

One builder per reference head module (networks/deeplabv3.py,
networks/deeplabv3p.py, networks/psp.py, networks/simple.py).  Every model
is a single layer-graph whose outputs are ``pred`` (and ``deepsup`` when
enabled); losses are applied by the trainer, not inside the model — the
reference ran the criterion inside ``forward`` purely as a DDP convenience
(networks/deeplabv3.py:55-57), which SPMD does not need.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

from dcfp_tpu_torch.graph.ir import Graph, GraphBuilder
from dcfp_tpu_torch.models.blocks import add_aspp, add_ppm
from dcfp_tpu_torch.models.resnet import add_resnet
from dcfp_tpu_torch.models.hrnet import add_hrnet


@dataclasses.dataclass
class SegModel:
    """A built segmentation model: graph + construction metadata."""
    graph: Graph
    name: str
    backbone: str
    num_classes: int
    align_corner: bool
    deepsup: bool
    backbone_para: Dict[str, Any]
    model_para: Dict[str, Any]

    @property
    def ignore_prune_layer(self):
        return self.graph.ignore_prune


def _add_backbone(b: GraphBuilder, x: str, backbone: str,
                  backbone_para: Dict[str, Any],
                  out_index: Sequence[int], align_corner: bool
                  ) -> Tuple[str, ...]:
    if backbone.startswith("resnet"):
        return add_resnet(
            b, x, depth=backbone,
            output_stride=backbone_para.get("os", 8),
            inplanes=backbone_para.get("inplanes", 128),
            mg_unit=backbone_para.get("mg_unit", [1, 2, 4]),
            out_index=backbone_para.get("out_index", out_index))
    if backbone.startswith("hrnet"):
        return add_hrnet(b, x, width=backbone_para.get("width", 48),
                         align_corner=align_corner)
    raise NotImplementedError(f"backbone {backbone!r}")


def _classifier_3conv(b: GraphBuilder, x: str, in_relu_ch: int,
                      num_classes: int, prefix: str = "last_conv") -> str:
    """conv3x3-BN-ReLU x2 + 1x1 classifier (deeplabv3.py:25-33)."""
    y = b.conv(x, f"{prefix}.0", out_ch=256, kernel=3, padding=1)
    y = b.bn(y, f"{prefix}.1")
    y = b.relu(y, f"{prefix}.relu0")
    y = b.conv(y, f"{prefix}.3", out_ch=256, kernel=3, padding=1)
    y = b.bn(y, f"{prefix}.4")
    y = b.relu(y, f"{prefix}.relu1")
    return b.conv(y, f"{prefix}.6", out_ch=num_classes, kernel=1, padding=0,
                  bias=True)


def _deepsup_head(b: GraphBuilder, feat: str, num_classes: int,
                  align_corner: bool) -> str:
    """Aux head on the stage-3 feature (deeplabv3.py:36-41)."""
    y = b.conv(feat, "conv_deepsup.0", out_ch=512, kernel=3, padding=1)
    y = b.bn(y, "conv_deepsup.1")
    y = b.relu(y, "conv_deepsup.relu")
    y = b.dropout(y, "conv_deepsup.3", rate=0.1, spatial=True)
    y = b.conv(y, "conv_deepsup.4", out_ch=num_classes, kernel=1, padding=0,
               bias=True)
    return b.resize(y, "deepsup", to_input=True, align_corners=align_corner)


def build_deeplabv3(backbone="resnet50", backbone_para=None, model_para=None,
                    num_classes=21, align_corner=False, deepsup=False
                    ) -> SegModel:
    """DeepLabV3 (reference networks/deeplabv3.py:12-59)."""
    backbone_para = dict(backbone_para or {})
    model_para = dict(model_para or {})
    b = GraphBuilder("deeplabv3")
    img = b.input("image")
    feats = _add_backbone(b, img, backbone, backbone_para, (3, 4),
                          align_corner)
    x_deepsup, x = feats[-2], feats[-1]
    x = add_aspp(b, x, output_stride=backbone_para.get("os", 8),
                 align_corner=align_corner)
    x = _classifier_3conv(b, x, 512, num_classes)
    pred = b.resize(x, "pred", to_input=True, align_corners=align_corner)
    outputs = [pred]
    if deepsup:
        outputs.append(_deepsup_head(b, x_deepsup, num_classes, align_corner))
    g = b.finish(outputs)
    g.ignore_prune = (model_para.get("no_prune", ["aspp.bn1"]) +
                      backbone_para.get("no_prune",
                                        ["backbone.layer4.2.bn3"]))
    return SegModel(g, "deeplabv3", backbone, num_classes, align_corner,
                    deepsup, backbone_para, model_para)


def build_deeplabv3p(backbone="resnet50", backbone_para=None,
                     model_para=None, num_classes=21, align_corner=False,
                     deepsup=False) -> SegModel:
    """DeepLabV3+ with low-level decoder (reference networks/deeplabv3p.py)."""
    backbone_para = dict(backbone_para or {})
    model_para = dict(model_para or {})
    b = GraphBuilder("deeplabv3p")
    img = b.input("image")
    feats = _add_backbone(b, img, backbone, backbone_para, (1, 3, 4),
                          align_corner)
    low_level, x_deepsup, x = feats
    x = add_aspp(b, x, output_stride=backbone_para.get("os", 8),
                 align_corner=align_corner)
    # decoder (deeplabv3p.py:12-41)
    low = b.conv(low_level, "decoder.conv1", out_ch=48, kernel=1, padding=0)
    low = b.bn(low, "decoder.bn1")
    low = b.relu(low, "decoder.relu")
    x = b.resize(x, "decoder.up", like=low, align_corners=align_corner)
    x = b.concat([x, low], "decoder.cat")
    x = _classifier_3conv(b, x, 512 + 48, num_classes,
                          prefix="decoder.last_conv")
    pred = b.resize(x, "pred", to_input=True, align_corners=align_corner)
    outputs = [pred]
    if deepsup:
        outputs.append(_deepsup_head(b, x_deepsup, num_classes, align_corner))
    g = b.finish(outputs)
    g.ignore_prune = (model_para.get("no_prune", ["decoder.bn1", "aspp.bn1"])
                      + backbone_para.get("no_prune",
                                          ["backbone.layer4.2.bn3"]))
    return SegModel(g, "deeplabv3p", backbone, num_classes, align_corner,
                    deepsup, backbone_para, model_para)


def build_psp(backbone="resnet50", backbone_para=None, model_para=None,
              num_classes=21, align_corner=False, deepsup=False) -> SegModel:
    """PSPNet (reference networks/psp.py:12-49)."""
    backbone_para = dict(backbone_para or {})
    model_para = dict(model_para or {})
    b = GraphBuilder("psp")
    img = b.input("image")
    feats = _add_backbone(b, img, backbone, backbone_para, (3, 4),
                          align_corner)
    x_deepsup, x = feats[-2], feats[-1]
    x = add_ppm(b, x, out_features=512, align_corner=align_corner)
    x = b.conv(x, "last_conv", out_ch=num_classes, kernel=1, padding=0,
               bias=True)
    pred = b.resize(x, "pred", to_input=True, align_corners=align_corner)
    outputs = [pred]
    if deepsup:
        outputs.append(_deepsup_head(b, x_deepsup, num_classes, align_corner))
    g = b.finish(outputs)
    g.ignore_prune = backbone_para.get("no_prune",
                                       ["backbone.layer4.2.bn3"])
    return SegModel(g, "psp", backbone, num_classes, align_corner, deepsup,
                    backbone_para, model_para)


def build_simple(backbone="resnet50", backbone_para=None, model_para=None,
                 num_classes=21, align_corner=False, deepsup=False
                 ) -> SegModel:
    """Minimal FCN head (reference networks/simple.py:11-63)."""
    backbone_para = dict(backbone_para or {})
    model_para = dict(model_para or {})
    b = GraphBuilder("simple")
    img = b.input("image")
    if backbone.startswith("hrnet"):
        feats = _add_backbone(b, img, backbone, backbone_para, (4,),
                              align_corner)
        x_deepsup = x = feats[-1]
    else:
        feats = _add_backbone(b, img, backbone, backbone_para, (3, 4),
                              align_corner)
        x_deepsup, x = feats[-2], feats[-1]
    x = _classifier_3conv(b, x, 0, num_classes)
    pred = b.resize(x, "pred", to_input=True, align_corners=align_corner)
    outputs = [pred]
    if deepsup:
        outputs.append(_deepsup_head(b, x_deepsup, num_classes, align_corner))
    g = b.finish(outputs)
    g.ignore_prune = (model_para.get("no_prune", []) +
                      backbone_para.get("no_prune",
                                        ["backbone.layer4.2.bn3"]
                                        if backbone.startswith("resnet")
                                        else []))
    return SegModel(g, "simple", backbone, num_classes, align_corner,
                    deepsup, backbone_para, model_para)
