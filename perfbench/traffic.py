"""The one traffic generator: it reads a mix's parameters
(``perfbench/workloads/<traffic>.json``) and makes its inputs from the
seed, on the device in bulk, kept in pinned host memory.

* ``frames``: a pool of float32 NCHW frames (normalized-image values,
  standard normal) and the order in which a closed loop sends them: a
  seeded permutation of the pool, repeated, so every seed sends the same
  sizes.
* ``batches``: a pool of compact train batches as the data loader ships
  them (``cli/train.py``'s ``--compact-batches``): uint8 NHWC images,
  uint8 label maps, per-image class-weight vectors and the ``pad``
  triples.  Labels are blocks of ``label_block`` pixels whose classes are
  drawn from a long tail (class c with probability proportional to
  (c + 1) ** -zipf), with ``ignore_share`` of the pixels ignored; an
  image's class weights are the inverse square roots of each class's
  pixel share in it, as a balance-weighted loader gives the rare classes
  more weight; ``pad_share`` of the images carry a valid region smaller
  than the crop (a scaled-down image padded to the crop), half of them
  mirrored.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch


def _host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in pinned host memory (plain host memory without
    CUDA, where nothing is pinned)."""
    out = torch.empty(t.shape, dtype=t.dtype,
                      pin_memory=torch.cuda.is_available())
    out.copy_(t)
    return out


def _gen(seed: int, device, salt: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + salt) % (2 ** 63))
    return g


def frames(traffic: dict, seed: int, device) -> torch.Tensor:
    """(pool, batch, 3, H, W) float32 frames in pinned host memory."""
    h, w = traffic["frame_hw"]
    shape = (traffic["pool_frames"], traffic["batch"], 3, h, w)
    dev = torch.randn(shape, generator=_gen(seed, device, 1), device=device)
    return _host(dev)


def request_order(traffic: dict, seed: int, n: int) -> List[int]:
    """Pool indices of the first ``n`` requests."""
    rng = np.random.default_rng([int(seed), 2])
    perm = rng.permutation(traffic["pool_frames"])
    return [int(perm[i % len(perm)]) for i in range(n)]


def batches(traffic: dict, desc: dict, seed: int, device) -> Dict:
    """The pool of compact batches, each tensor (pool, batch, ...)."""
    p, n = traffic["pool_batches"], traffic["global_batch"]
    h, w = traffic["crop_hw"]
    c, ignore = desc["num_classes"], desc["ignore_label"]
    g = _gen(seed, device, 3)
    img = torch.randint(0, 256, (p, n, h, w, 3), generator=g,
                        device=device, dtype=torch.uint8)
    blk = traffic["label_block"]
    gh, gw = -(-h // blk), -(-w // blk)
    probs = (torch.arange(c, device=device, dtype=torch.float64) + 1.0) \
        ** -traffic["class_zipf"]
    cls = torch.multinomial(probs.float(), p * n * gh * gw, True,
                            generator=g).view(p, n, gh, gw)
    ori = cls.repeat_interleave(blk, 2).repeat_interleave(blk, 3)
    ori = ori[:, :, :h, :w]
    ori = torch.where(torch.rand(ori.shape, generator=g, device=device)
                      < traffic["ignore_share"], ignore, ori)
    counts = torch.zeros(p * n, c + 1, device=device)
    flat = torch.where(ori == ignore, c, ori).view(p * n, -1)
    counts.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.float32))
    share = counts[:, :c] / counts[:, :c].sum(1, keepdim=True).clamp(min=1)
    wc = torch.where(share > 0, share.clamp(min=1e-6).rsqrt(), 1.0)
    wc = wc / wc[:, :c].mean(1, keepdim=True)
    wc = torch.cat([wc, torch.zeros(p * n, 1, device=device)], 1)
    rng = np.random.default_rng([int(seed), 4])
    pad = np.tile(np.array([h, w, 0], np.int32), (p * n, 1))
    padded = rng.random(p * n) < traffic["pad_share"]
    pad[padded, 0] = rng.integers(h // 2, h, padded.sum())
    pad[padded, 1] = rng.integers(w // 2, w, padded.sum())
    pad[padded, 2] = rng.random(padded.sum()) < 0.5
    return {"img": _host(img),
            "ori": _host(ori.to(torch.uint8)),
            "weight_class": _host(wc.view(p, n, c + 1)),
            "pad": _host(torch.from_numpy(pad).view(p, n, 3))}


def batch(pool: Dict, i: int, rows: slice = slice(None)) -> Dict:
    """Batch ``i`` of the pool (images ``rows`` of it) as the loader
    hands it to the train step."""
    return {"img": pool["img"][i, rows],
            "label": {"ori": pool["ori"][i, rows],
                      "weight_class": pool["weight_class"][i, rows]},
            "pad": pool["pad"][i, rows]}


def batch_stream(pool: Dict, rows: slice = slice(None)) -> Iterator[Dict]:
    """The pool's batches in order, round and round."""
    i = 0
    while True:
        yield batch(pool, i % pool["img"].shape[0], rows)
        i += 1
