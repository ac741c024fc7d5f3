"""The stem conv's phase-plane input (port of ``dcfp_tpu/ops/stem.py``
``stem_plan`` and ``dcfp_tpu/ops/pallas_kernels.py``
``extract_stem_phases``).

A 3x3 / stride-2 / pad-1 conv reads its image at stride 2.  Split the
zero-padded image into its four stride-2 phases and every tap becomes a
unit-stride window of one phase plane; the stem conv kernel (K2,
``dcfp_tpu_torch.ops.kernels.stem_conv3x3_s2``) reads them so.  The
``phases`` deploy input format hands the planes over precomputed.

The planes keep the JAX package's ``(4*C, Hp, Wp)`` layout, row padding
included, so one phases array feeds either package.

The JAX package's ``conv3x3_s2_nchw`` (one-hot decimation matmuls) is
not ported: it works around the TPU's lane padding of thin NHWC tensors,
and the port's ``nchw`` input already goes straight into its NCHW graph.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

# The JAX kernel tiles output rows by 16 and reads 8 carry rows past each
# tile, so its planes hold that many rows; the port keeps the layout.
STEM_ROW_TILE = 16
STEM_CARRY_ROWS = 8


def extract_stem_phases(image: Union[np.ndarray, torch.Tensor]
                        ) -> Union[np.ndarray, torch.Tensor]:
    """(H, W, C) image -> (4*C, Hp, Wp) stride-2 phase planes, as a numpy
    array for a numpy image (host side) and as a tensor on the image's
    device for a tensor.

    Plane ``p = (a*2 + b)*C + c`` holds ``xpad[a::2, b::2, c]``, where
    ``xpad`` is the image zero-padded by one pixel on each side; the rest
    of each plane is zero."""
    h, w, c = image.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    hp = -(-(ho + 1) // STEM_ROW_TILE) * STEM_ROW_TILE + STEM_CARRY_ROWS
    wp = wo + 1
    if isinstance(image, np.ndarray):
        xp = np.pad(image, ((1, 1), (1, 1), (0, 0)))
        planes = [np.pad(p, ((0, hp - p.shape[0]), (0, wp - p.shape[1])))
                  for p in _phase_slices(xp, c)]
        return np.stack(planes)
    xp = F.pad(image.permute(2, 0, 1), (1, 1, 1, 1))  # (C, H+2, W+2)
    planes = [F.pad(p, (0, wp - p.shape[1], 0, hp - p.shape[0]))
              for p in _phase_slices(xp.permute(1, 2, 0), c)]
    return torch.stack(planes)


def _phase_slices(xp, c):
    """The 4*C planes ``xp[a::2, b::2, ch]`` of an (H+2, W+2, C) array,
    in plane order."""
    return [xp[a::2, b::2, ch] for a in (0, 1) for b in (0, 1)
            for ch in range(c)]


def stem_plan(graph) -> Optional[Tuple[str, str]]:
    """If the graph's (single) input feeds exactly one conv that the fast
    stem paths cover — k3, stride 2, padding 1, dilation 1, groups 1,
    in_ch <= 4 — return (input_name, conv_name), else None."""
    if len(graph.inputs) != 1:
        return None
    inp = graph.inputs[0]
    consumers = graph.consumers(inp)
    if len(consumers) != 1 or consumers[0].op != "conv":
        return None
    a = consumers[0].attrs
    if (a["kernel"] == 3 and a["stride"] == 2 and a["padding"] == 1
            and a["dilation"] == 1 and a["groups"] == 1
            and a["in_ch"] <= 4):
        return inp, consumers[0].name
    return None
