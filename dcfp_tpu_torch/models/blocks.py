"""Shared head blocks: ASPP, PPM, SE (reference networks/tools/*)."""

from __future__ import annotations

from typing import Sequence


def add_aspp(b, x: str, *, output_stride: int, align_corner: bool,
             outplanes: int = 512, prefix: str = "aspp") -> str:
    """Atrous spatial pyramid pooling (reference networks/tools/aspp.py:37-85):
    1x1 + three dilated 3x3 branches + global-pool branch, concat, 1x1."""
    if output_stride == 16:
        dilations = [1, 6, 12, 18]
    elif output_stride == 8:
        dilations = [1, 12, 24, 36]
    elif output_stride == 32:
        dilations = [1, 3, 6, 9]
    else:
        raise NotImplementedError(f"output_stride={output_stride}")

    a1 = b.conv(x, f"{prefix}.aspp1.atrous_conv", out_ch=256, kernel=1,
                padding=0)
    a1 = b.bn(a1, f"{prefix}.aspp1.bn")
    a1 = b.relu(a1, f"{prefix}.aspp1.relu")
    branches = [a1]
    for i, d in enumerate(dilations[1:], start=2):
        a = b.conv(x, f"{prefix}.aspp{i}.atrous_conv", out_ch=256, kernel=3,
                   dilation=d, padding=d)
        a = b.bn(a, f"{prefix}.aspp{i}.bn")
        a = b.relu(a, f"{prefix}.aspp{i}.relu")
        branches.append(a)

    g = b.globalpool(x, f"{prefix}.global_avg_pool.pool")
    g = b.conv(g, f"{prefix}.global_avg_pool.1", out_ch=256, kernel=1,
               padding=0)
    g = b.bn(g, f"{prefix}.global_avg_pool.2")
    g = b.relu(g, f"{prefix}.global_avg_pool.relu")
    g = b.resize(g, f"{prefix}.global_avg_pool.up", like=branches[-1],
                 align_corners=align_corner)
    branches.append(g)

    cat = b.concat(branches, f"{prefix}.cat")
    y = b.conv(cat, f"{prefix}.conv1", out_ch=outplanes, kernel=1, padding=0)
    y = b.bn(y, f"{prefix}.bn1")
    return b.relu(y, f"{prefix}.relu")


def add_ppm(b, x: str, *, out_features: int = 512,
            sizes: Sequence[int] = (1, 2, 3, 6), align_corner: bool = False,
            prefix: str = "ppm") -> str:
    """Pyramid pooling module (reference networks/tools/ppm.py:10-39)."""
    priors = []
    for i, size in enumerate(sizes):
        p = b.adaptive_avgpool(x, f"{prefix}.stages.{i}.0", out_size=size)
        p = b.conv(p, f"{prefix}.stages.{i}.1", out_ch=out_features,
                   kernel=1, padding=0)
        p = b.bn(p, f"{prefix}.stages.{i}.2")
        p = b.relu(p, f"{prefix}.stages.{i}.relu")
        p = b.resize(p, f"{prefix}.stages.{i}.up", like=x,
                     align_corners=align_corner)
        priors.append(p)
    priors.append(x)
    cat = b.concat(priors, f"{prefix}.cat")
    y = b.conv(cat, f"{prefix}.bottleneck.0", out_ch=out_features, kernel=3,
               padding=1)
    y = b.bn(y, f"{prefix}.bottleneck.1")
    return b.relu(y, f"{prefix}.bottleneck.relu")


def add_se(b, x: str, *, reduction: int = 16, prefix: str = "se") -> str:
    """Squeeze-excitation gate (reference networks/tools/se_module.py:10-25):
    global pool -> 1x1 reduce -> relu -> 1x1 expand -> sigmoid -> scale."""
    ch = b.channels(x)
    g = b.globalpool(x, f"{prefix}.avg_pool")
    g = b.conv(g, f"{prefix}.fc1", out_ch=max(ch // reduction, 1), kernel=1,
               padding=0, bias=True)
    g = b.relu(g, f"{prefix}.relu")
    g = b.conv(g, f"{prefix}.fc2", out_ch=ch, kernel=1, padding=0, bias=True)
    g = b.sigmoid(g, f"{prefix}.sigmoid")
    return b.mul([x, g], f"{prefix}.scale")
