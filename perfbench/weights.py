"""Seeded weights, made on the device in a few large draws.

One normal draw covers every conv kernel and bias, one uniform draw every
BN entry; each leaf is a slice of it, scaled.  Kernels are He-normal,
N(0, 2 / fan_in), the ResNet authors' init, so that every residual
branch carries as much signal as the path around it; BN scale U(0.5, 1.5),
bias U(-0.1, 0.1), running mean U(-0.1, 0.1), running var U(0.5, 1.5),
so that folding BN into the convs has work to do.  The classifiers'
biases are zero (see the configuration files).  The same seed gives the
same weights on the same kind of device.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.deeplab import CLASSIFIERS, bn_of, convs


def make(desc: dict, seed: int, device: torch.device):
    """(params, state) of ``desc``'s model on ``device``, float32, in the
    layout both the program and the reference read: ``params[conv] =
    {"kernel": OIHW, "bias"?}``, ``params[bn] = {"scale", "bias"}``,
    ``state[bn] = {"mean", "var"}``."""
    layers = convs(desc)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = [c.cout * c.cin * c.k * c.k + (c.cout if c.bias else 0)
             for c in layers]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    bn_layers = [(bn_of(c.name), c.cout) for c in layers
                 if bn_of(c.name) is not None]
    bn_flat = torch.rand(4 * sum(ch for _, ch in bn_layers), generator=gen,
                         device=device)
    params, state = {}, {}
    off = 0
    for c, n in zip(layers, sizes):
        std = math.sqrt(2.0 / (c.cin * c.k * c.k))
        chunk = flat[off:off + n].mul_(std)
        off += n
        kn = c.cout * c.cin * c.k * c.k
        p = {"kernel": chunk[:kn].view(c.cout, c.cin, c.k, c.k)}
        if c.bias:
            p["bias"] = chunk[kn:]
            if c.name in CLASSIFIERS:
                p["bias"].zero_()
        params[c.name] = p
    off = 0
    for name, ch in bn_layers:
        u = bn_flat[off:off + 4 * ch].view(4, ch)
        off += 4 * ch
        params[name] = {"scale": u[0] + 0.5, "bias": (u[1] - 0.5) * 0.2}
        state[name] = {"mean": (u[2] - 0.5) * 0.2, "var": u[3] + 0.5}
    return params, state

