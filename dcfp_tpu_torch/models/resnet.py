"""Dilated ResNet-D backbones (50/101/152) on the layer-graph IR.

Re-implements the capability of reference networks/backbone/resnet.py:
deep 3-conv stem (resnet.py:88-98), output-stride-controlled strides and
dilations (resnet.py:67-77), multi-grid layer4 (resnet.py:124-141), and
multi-feature output via ``out_index`` (resnet.py:151-157).

Node names match the reference's module paths (e.g.
``backbone.layer4.2.bn3``) so torch checkpoints convert by name and the
models' ``ignore_prune_layer`` entries line up verbatim.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from dcfp_tpu_torch.graph.ir import GraphBuilder

LAYER_DEFS = {
    "resnet50": [3, 4, 6, 3],
    "resnet101": [3, 4, 23, 3],
    "resnet152": [3, 8, 36, 3],
}


def _bottleneck(b: GraphBuilder, prefix: str, x: str, planes: int, *,
                stride: int = 1, dilation: int = 1,
                downsample: bool = False) -> str:
    expansion = 4
    c = b.conv(x, f"{prefix}.conv1", out_ch=planes, kernel=1, stride=1)
    c = b.bn(c, f"{prefix}.bn1")
    c = b.relu(c, f"{prefix}.relu1")
    c = b.conv(c, f"{prefix}.conv2", out_ch=planes, kernel=3, stride=stride,
               dilation=dilation, padding=dilation)
    c = b.bn(c, f"{prefix}.bn2")
    c = b.relu(c, f"{prefix}.relu2")
    c = b.conv(c, f"{prefix}.conv3", out_ch=planes * expansion, kernel=1)
    c = b.bn(c, f"{prefix}.bn3")
    if downsample:
        d = b.conv(x, f"{prefix}.downsample.0", out_ch=planes * expansion,
                   kernel=1, stride=stride, padding=0)
        d = b.bn(d, f"{prefix}.downsample.1")
        residual = d
    else:
        residual = x
    s = b.add_([c, residual], f"{prefix}.sum")
    return b.relu(s, f"{prefix}.out")


def add_resnet(b: GraphBuilder, x: str, *, depth: str = "resnet50",
               output_stride: int = 8, inplanes: int = 128,
               mg_unit: Sequence[int] = (1, 2, 4),
               out_index: Sequence[int] = (3, 4),
               prefix: str = "backbone") -> Tuple[str, ...]:
    """Append a dilated ResNet to builder ``b``; returns feature node names
    for each stage in ``out_index`` (1..4)."""
    layers = LAYER_DEFS[depth]
    if output_stride == 16:
        strides, dilations = [1, 2, 2, 1], [1, 1, 1, 2]
    elif output_stride == 8:
        strides, dilations = [1, 2, 1, 1], [1, 1, 2, 4]
    elif output_stride == 32:
        strides, dilations = [1, 2, 2, 2], [1, 1, 1, 1]
    else:
        raise NotImplementedError(f"output_stride={output_stride}")

    # deep stem (reference resnet.py:88-98): sequential indices match the
    # torch nn.Sequential so checkpoint names convert directly.
    c = b.conv(x, f"{prefix}.conv1.0", out_ch=64, kernel=3, stride=2,
               padding=1)
    c = b.bn(c, f"{prefix}.conv1.1")
    c = b.relu(c, f"{prefix}.conv1.relu0")
    c = b.conv(c, f"{prefix}.conv1.3", out_ch=64, kernel=3, padding=1)
    c = b.bn(c, f"{prefix}.conv1.4")
    c = b.relu(c, f"{prefix}.conv1.relu1")
    c = b.conv(c, f"{prefix}.conv1.6", out_ch=inplanes, kernel=3, padding=1)
    c = b.bn(c, f"{prefix}.bn1")
    c = b.relu(c, f"{prefix}.relu1")
    c = b.maxpool(c, f"{prefix}.maxpool", kernel=3, stride=2, padding=1)

    in_ch = inplanes
    planes_per_stage = [64, 128, 256, 512]
    outs: Dict[int, str] = {}
    for stage in range(1, 4):  # layer1..layer3
        planes = planes_per_stage[stage - 1]
        n_blocks = layers[stage - 1]
        for i in range(n_blocks):
            stride = strides[stage - 1] if i == 0 else 1
            need_ds = (i == 0 and (stride != 1 or in_ch != planes * 4))
            c = _bottleneck(b, f"{prefix}.layer{stage}.{i}", c, planes,
                            stride=stride, dilation=dilations[stage - 1],
                            downsample=need_ds)
            in_ch = planes * 4
        outs[stage] = c

    # layer4: multi-grid unit (reference resnet.py:124-141)
    planes = planes_per_stage[3]
    for i, mg in enumerate(mg_unit):
        stride = strides[3] if i == 0 else 1
        need_ds = (i == 0 and (stride != 1 or in_ch != planes * 4))
        c = _bottleneck(b, f"{prefix}.layer4.{i}", c, planes, stride=stride,
                        dilation=mg * dilations[3], downsample=need_ds)
        in_ch = planes * 4
    outs[4] = c

    return tuple(outs[i] for i in out_index)
