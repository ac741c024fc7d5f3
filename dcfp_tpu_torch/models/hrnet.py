"""HRNetV2-W48 backbone on the layer-graph IR.

Capability parity with reference networks/backbone/hrnet.py: stem
(hrnet.py:267-275), Bottleneck layer1 (:275), three multi-resolution
stages of HighResolutionModules with transition layers (:277-304), full
cross-resolution fusion with strided-conv downsampling / bilinear
upsampling (:224-249), and the 4-branch upsample-concat output
(:426-438).  Node names mirror the torch module paths (including nested
``nn.Sequential`` indices) so checkpoints convert by name.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from dcfp_tpu_torch.graph.ir import GraphBuilder

HRNET_CFGS = {
    48: {
        "stage2": {"modules": 1, "branches": 2, "blocks": (4, 4),
                   "channels": (48, 96)},
        "stage3": {"modules": 4, "branches": 3, "blocks": (4, 4, 4),
                   "channels": (48, 96, 192)},
        "stage4": {"modules": 3, "branches": 4, "blocks": (4, 4, 4, 4),
                   "channels": (48, 96, 192, 384)},
    },
    18: {
        "stage2": {"modules": 1, "branches": 2, "blocks": (4, 4),
                   "channels": (18, 36)},
        "stage3": {"modules": 4, "branches": 3, "blocks": (4, 4, 4),
                   "channels": (18, 36, 72)},
        "stage4": {"modules": 3, "branches": 4, "blocks": (4, 4, 4, 4),
                   "channels": (18, 36, 72, 144)},
    },
}


def _basic_block(b: GraphBuilder, prefix: str, x: str, planes: int, *,
                 stride: int = 1, downsample: bool = False) -> str:
    c = b.conv(x, f"{prefix}.conv1", out_ch=planes, kernel=3, stride=stride,
               padding=1)
    c = b.bn(c, f"{prefix}.bn1")
    c = b.relu(c, f"{prefix}.relu1")
    c = b.conv(c, f"{prefix}.conv2", out_ch=planes, kernel=3, padding=1)
    c = b.bn(c, f"{prefix}.bn2")
    if downsample:
        d = b.conv(x, f"{prefix}.downsample.0", out_ch=planes, kernel=1,
                   stride=stride, padding=0)
        d = b.bn(d, f"{prefix}.downsample.1")
        residual = d
    else:
        residual = x
    s = b.add_([c, residual], f"{prefix}.sum")
    return b.relu(s, f"{prefix}.out")


def _bottleneck(b: GraphBuilder, prefix: str, x: str, planes: int, *,
                stride: int = 1, downsample: bool = False) -> str:
    c = b.conv(x, f"{prefix}.conv1", out_ch=planes, kernel=1, padding=0)
    c = b.bn(c, f"{prefix}.bn1")
    c = b.relu(c, f"{prefix}.relu1")
    c = b.conv(c, f"{prefix}.conv2", out_ch=planes, kernel=3, stride=stride,
               padding=1)
    c = b.bn(c, f"{prefix}.bn2")
    c = b.relu(c, f"{prefix}.relu2")
    c = b.conv(c, f"{prefix}.conv3", out_ch=planes * 4, kernel=1, padding=0)
    c = b.bn(c, f"{prefix}.bn3")
    if downsample:
        d = b.conv(x, f"{prefix}.downsample.0", out_ch=planes * 4, kernel=1,
                   stride=stride, padding=0)
        d = b.bn(d, f"{prefix}.downsample.1")
        residual = d
    else:
        residual = x
    s = b.add_([c, residual], f"{prefix}.sum")
    return b.relu(s, f"{prefix}.out")


def _fuse(b: GraphBuilder, prefix: str, xs: List[str], channels: Sequence[int],
          align_corner: bool) -> List[str]:
    """Full cross-resolution fusion (reference hrnet.py:177-249)."""
    n = len(xs)
    fused = []
    for i in range(n):
        terms = []
        for j in range(n):
            if j == i:
                terms.append(xs[j])
            elif j > i:
                # 1x1 conv + BN, then bilinear upsample to branch i
                y = b.conv(xs[j], f"{prefix}.fuse_layers.{i}.{j}.0",
                           out_ch=channels[i], kernel=1, padding=0)
                y = b.bn(y, f"{prefix}.fuse_layers.{i}.{j}.1")
                y = b.resize(y, f"{prefix}.fuse_layers.{i}.{j}.up",
                             like=xs[i], align_corners=align_corner)
                terms.append(y)
            else:
                # chain of strided 3x3 convs down from branch j to i
                y = xs[j]
                for k in range(i - j):
                    last = (k == i - j - 1)
                    out_ch = channels[i] if last else channels[j]
                    y = b.conv(y, f"{prefix}.fuse_layers.{i}.{j}.{k}.0",
                               out_ch=out_ch, kernel=3, stride=2, padding=1)
                    y = b.bn(y, f"{prefix}.fuse_layers.{i}.{j}.{k}.1")
                    if not last:
                        y = b.relu(y, f"{prefix}.fuse_layers.{i}.{j}.{k}.relu")
                terms.append(y)
        s = b.add_(terms, f"{prefix}.fuse.{i}.sum")
        fused.append(b.relu(s, f"{prefix}.fuse.{i}.out"))
    return fused


def _hr_module(b: GraphBuilder, prefix: str, xs: List[str],
               channels: Sequence[int], num_blocks: Sequence[int],
               align_corner: bool) -> List[str]:
    ys = []
    for br, x in enumerate(xs):
        c = x
        for blk in range(num_blocks[br]):
            c = _basic_block(b, f"{prefix}.branches.{br}.{blk}", c,
                             channels[br])
        ys.append(c)
    if len(ys) == 1:
        return ys
    return _fuse(b, prefix, ys, channels, align_corner)


def _transition(b: GraphBuilder, prefix: str, xs: List[str],
                pre_ch: Sequence[int], cur_ch: Sequence[int]) -> List[str]:
    """Transition layers (reference hrnet.py:306-340, forward :398-419).

    Quirk preserved: a non-None transition is applied to the LAST previous
    branch output (hrnet.py:401,409,417)."""
    out = []
    for i in range(len(cur_ch)):
        if i < len(pre_ch):
            if cur_ch[i] != pre_ch[i]:
                y = b.conv(xs[-1], f"{prefix}.{i}.0", out_ch=cur_ch[i],
                           kernel=3, padding=1)
                y = b.bn(y, f"{prefix}.{i}.1")
                out.append(b.relu(y, f"{prefix}.{i}.relu"))
            else:
                out.append(xs[i])
        else:
            y = xs[-1]
            for j in range(i + 1 - len(pre_ch)):
                out_ch = cur_ch[i] if j == i - len(pre_ch) else pre_ch[-1]
                y = b.conv(y, f"{prefix}.{i}.{j}.0", out_ch=out_ch, kernel=3,
                           stride=2, padding=1)
                y = b.bn(y, f"{prefix}.{i}.{j}.1")
                y = b.relu(y, f"{prefix}.{i}.{j}.relu")
            out.append(y)
    return out


def add_hrnet(b: GraphBuilder, x: str, *, width: int = 48,
              align_corner: bool = False,
              prefix: str = "backbone") -> Tuple[str, ...]:
    """Append HRNetV2 to builder ``b``; returns a single concat feature
    (4 branches upsampled to 1/4 resolution), channels = sum of widths."""
    cfg = HRNET_CFGS[width]

    c = b.conv(x, f"{prefix}.conv1", out_ch=64, kernel=3, stride=2, padding=1)
    c = b.bn(c, f"{prefix}.bn1")
    c = b.relu(c, f"{prefix}.relu1")
    c = b.conv(c, f"{prefix}.conv2", out_ch=64, kernel=3, stride=2, padding=1)
    c = b.bn(c, f"{prefix}.bn2")
    c = b.relu(c, f"{prefix}.relu2")

    for i in range(4):
        c = _bottleneck(b, f"{prefix}.layer1.{i}", c, 64, downsample=(i == 0))
    xs, pre_ch = [c], [256]

    for stage_idx in (2, 3, 4):
        scfg = cfg[f"stage{stage_idx}"]
        cur_ch = list(scfg["channels"])
        xs = _transition(b, f"{prefix}.transition{stage_idx - 1}", xs,
                         pre_ch, cur_ch)
        for m in range(scfg["modules"]):
            xs = _hr_module(b, f"{prefix}.stage{stage_idx}.{m}", xs, cur_ch,
                            scfg["blocks"], align_corner)
        pre_ch = cur_ch

    ups = [xs[0]]
    for i in range(1, 4):
        ups.append(b.resize(xs[i], f"{prefix}.final_up.{i}", like=xs[0],
                            align_corners=align_corner))
    cat = b.concat(ups, f"{prefix}.final_cat")
    return (cat,)
