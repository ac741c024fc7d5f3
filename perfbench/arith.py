"""The yardstick's arithmetic: published peaks of one NVIDIA H100 (SXM,
dense, at its 700 W limit), the model's operation count, and K1's bound.

The operation count follows the DCFP repository's MAC conventions
(``utils/flops_counter.py``, which the port's ``utils/flops.
count_flops_params`` copies): a conv's k*k*cin*cout MACs per output pixel
plus its bias, 2 per BN element, 1 per ReLU output and per pooled input
element.  A FLOP is two of them.
"""

from __future__ import annotations

from perfbench.reference.deeplab import (ASPP_DILATIONS, STAGES, bn_of,
                                         convs)

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12     # tensor cores, dense
TF32_FLOPS = 495e12     # tensor cores, dense
F32_FLOPS = 67e12       # outside the tensor cores (FMA = 2)
PEAKS = {"bfloat16": BF16_FLOPS, "tf32": TF32_FLOPS, "float32": F32_FLOPS}


def _out(h: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (h + 2 * p - d * (k - 1) - 1) // s + 1


def macs(desc: dict, hw, batch: int = 1) -> int:
    """MACs of one forward pass of ``batch`` images of size ``hw``."""
    h1 = tuple(_out(x, 3, 2, 1) for x in hw)       # stem, stride 2
    h2 = tuple(_out(x, 3, 2, 1) for x in h1)       # max pool
    h3 = tuple(_out(x, 3, 2, 1) for x in h2)       # layer2 on: stride 8
    area = {1: h1[0] * h1[1], 2: h2[0] * h2[1], 3: h3[0] * h3[1]}
    total = 0
    chans = {}
    for c in convs(desc):
        name = c.name
        if name.startswith("backbone.conv1"):
            a = area[1]
        elif name.startswith("backbone.layer1") or (
                name.startswith("backbone.layer2.0.conv1")):
            a = area[2]
        elif name == "aspp.global_avg_pool.1":
            a = 1
        else:
            a = area[3]
        total += c.k * c.k * c.cin * c.cout * a
        if c.bias:
            total += c.cout * a
        if bn_of(name) is not None:
            total += 2 * c.cout * a
        chans[name] = (c.cout, a)
    # ReLUs: the stem's three, two in each block plus the one after its
    # sum, every ASPP branch, the ASPP projection, the classifier's two
    # and the deep-supervision head's one
    relu = [chans[f"backbone.conv1.{i}"] for i in (0, 3, 6)]
    mg = desc["backbone_para"].get("mg_unit", [1, 2, 4])
    for s, n in enumerate(STAGES[desc["backbone"]]):
        for i in range(len(mg) if s == 3 else n):
            p = f"backbone.layer{s + 1}.{i}"
            relu += [chans[f"{p}.conv1"], chans[f"{p}.conv2"],
                     chans[f"{p}.conv3"]]
    relu += [chans["aspp.aspp1.atrous_conv"]]
    relu += [chans[f"aspp.aspp{j}.atrous_conv"]
             for j in range(2, 2 + len(ASPP_DILATIONS))]
    relu += [chans["aspp.global_avg_pool.1"], chans["aspp.conv1"],
             chans["last_conv.0"], chans["last_conv.3"]]
    if desc.get("deepsup"):
        relu.append(chans["conv_deepsup.0"])
    total += sum(ch * a for ch, a in relu)
    # pools read their input: the stem's max pool, the ASPP image pool
    total += chans["backbone.conv1.6"][0] * area[1]
    backbone_out = chans["backbone.layer4.0.conv3"][0]
    total += backbone_out * area[3]
    return total * batch


def k1_bound_s(n: int, c: int, h: int, w: int, out_h: int, out_w: int,
               logit_bytes: int = 2) -> float:
    """The least time of the resize-argmax tail: the bf16 logits read
    once and the uint8 labels written once over the HBM rate, or the
    separable interpolation (H pass on the (out_h, w) grid, W pass on
    the output grid, 2 multiplies and 1 add each) and the compare over
    the float32 rate, whichever is longer."""
    n_bytes = n * c * h * w * logit_bytes + n * out_h * out_w
    n_ops = n * c * (out_h * w * 3 + out_h * out_w * 4)
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS)
