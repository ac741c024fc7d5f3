"""Plain float32 finetune step of the DCFP recipe (scripts/cs/finetune.sh).

Written from the recipe, not from the program: the compact batch
expanded (uint8 image / 255, normalized, zero outside each image's
valid region; per-image class weights gathered into a pixel map), the
model's train-mode forward (:mod:`perfbench.reference.deeplab`, BN on
batch moments), GSRL with deep supervision, the gradients by autograd,
the DCFP EIC update on the raw gradients, and SGD with weight decay,
momentum and the poly schedule with linear warm-up.

The spatial dropout of the deep-supervision head follows the recipe's
seeded protocol, which the benchmark hands both sides as a generator:
each step draws one seed in [0, 2**62) per dropout layer from it, and
the layer keeps channel (n, c) where a uniform draw from a device
generator seeded with that seed, shaped (N, C, 1, 1), is below 0.9.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference import deeplab


def expand(batch: dict, desc: dict, device) -> tuple:
    """(NCHW float32 image, int64 labels, float32 pixel weights)."""
    img = batch["img"].to(device)
    norm = desc["finetune"]["normalize"]
    mean = torch.tensor(norm["mean"], device=device)
    std = torch.tensor(norm["std"], device=device)
    x = (img.float() / 255.0 - mean) / std
    n, h, w = img.shape[:3]
    pad = batch["pad"].to(device).long()
    ys = torch.arange(h, device=device)[None, :, None]
    xs = torch.arange(w, device=device)[None, None, :]
    hv, wv, fl = (pad[:, i][:, None, None] for i in range(3))
    valid = (ys < hv) & torch.where(fl > 0, xs >= w - wv, xs < wv)
    x = torch.where(valid[..., None], x, 0.0).permute(0, 3, 1, 2)
    ori = batch["label"]["ori"].to(device).long()
    wc = batch["label"]["weight_class"].to(device).float()
    c = desc["num_classes"]
    idx = torch.where(ori == desc["ignore_label"], c, ori)
    weight = torch.gather(wc, 1, idx.flatten(1)).view(idx.shape)
    return x.contiguous(), ori, weight


def gsrl(logits: Dict[str, torch.Tensor], labels, pixel_weight, desc):
    """GSRL (DCFP criterion.py:77-101): the k x k max-pooled pixel
    weight, times 1 + gamma * (1 - softmax top-2 margin) of the main
    head, zero at ignored pixels and held constant; each image's
    weighted CE sum over its weight sum, averaged over images; the
    deep-supervision head with the same weights, times ds_weight."""
    ft = desc["finetune"]
    ignore = desc["ignore_label"]
    k = ft["gsrl_k"]
    w = F.max_pool2d(pixel_weight[:, None], k, 1, k // 2)[:, 0]
    with torch.no_grad():
        top2 = torch.topk(torch.softmax(logits["pred"], 1), 2, 1).values
        margin = top2[:, 0] - top2[:, 1]
        w = (1.0 + ft["gsrl_gamma"] * (1.0 - margin)) * w
        w = torch.where(labels == ignore, 0.0, w)

    def term(z):
        valid = labels != ignore
        safe = torch.where(valid, labels, 0)
        nll = -torch.gather(F.log_softmax(z, 1), 1, safe[:, None])[:, 0]
        nll = torch.where(valid, nll, 0.0)
        num = (nll * w).sum(dim=(1, 2))
        den = w.sum(dim=(1, 2)) + 1e-8
        return (num / den).mean()

    loss = term(logits["pred"])
    if "deepsup" in logits:
        loss = loss + ft["ds_weight"] * term(logits["deepsup"])
    return loss


def learning_rate(count: int, ft: dict) -> float:
    """Poly decay with linear warm-up from 1e-6 of the base rate."""
    n = ft["num_steps"]
    lr = ft["learning_rate"] * (1.0 - min(count, n) / n) ** ft["power"]
    if ft["warmup"] > 0 and count < ft["warmup"]:
        lr *= 1.0 - (1.0 - count / ft["warmup"]) * (1.0 - 1e-6)
    return lr


def deepsup_keep(generator: torch.Generator, n: int, c: int, device):
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device)[0])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    u = torch.rand((n, c, 1, 1), generator=g, device=device)
    return u < 1.0 - deeplab.DEEPSUP_DROPOUT


class Trainer:
    """The recipe's state (params, BN statistics, momentum, EIC, step
    count) and its step."""

    def __init__(self, desc: dict, params, state):
        self.desc = desc
        self.params = {n: {k: v.detach().clone() for k, v in d.items()}
                       for n, d in params.items()}
        self.state = {n: {k: v.detach().clone() for k, v in d.items()}
                      for n, d in state.items()}
        self.trace = {n: {k: torch.zeros_like(v) for k, v in d.items()}
                      for n, d in self.params.items()}
        self.eic = {b: torch.zeros_like(self.params[b]["scale"])
                    for b in deeplab.prunable_bns(desc)}
        self.count = 0

    def step(self, batch: dict, generator: torch.Generator) -> Dict:
        """One step; returns {"loss", "grads"} (the raw gradients)."""
        desc, ft = self.desc, self.desc["finetune"]
        dev = next(iter(self.params.values()))["kernel"].device
        x, labels, pw = expand(batch, desc, dev)
        keys = [(n, k) for n, d in self.params.items() for k in d]
        leaves = [self.params[n][k].detach().requires_grad_(True)
                  for n, k in keys]
        p = {}
        for (n, k), t in zip(keys, leaves):
            p.setdefault(n, {})[k] = t
        keep = None
        if desc.get("deepsup"):
            c = p["conv_deepsup.0"]["kernel"].shape[0]
            keep = deepsup_keep(generator, x.shape[0], c, dev)
        out, new_state = deeplab.forward(desc, p, self.state, x, train=True,
                                         deepsup_keep=keep)
        hw = x.shape[-2:]
        up = {name: deeplab.upsample(z, hw, desc["align_corner"])
              for name, z in out.items()}
        loss = gsrl(up, labels, pw, desc)
        grads = torch.autograd.grad(loss, leaves)
        g = {}
        for (n, k), t in zip(keys, grads):
            g.setdefault(n, {})[k] = t
        with torch.no_grad():
            r = ft["eic_r"]
            for b, score in self.eic.items():
                gb, wb = g[b]["scale"], self.params[b]["scale"]
                self.eic[b] = torch.where(gb * wb > 0,
                                          r * score + (1 - r) * gb.abs(),
                                          score)
            lr = learning_rate(self.count, ft)
            for n, k in keys:
                u = g[n][k] + ft["weight_decay"] * self.params[n][k]
                self.trace[n][k] = u + ft["momentum"] * self.trace[n][k]
                self.params[n][k] = self.params[n][k] - lr * \
                    self.trace[n][k]
        self.state = {n: new_state.get(n, s) for n, s in self.state.items()}
        self.count += 1
        return {"loss": float(loss.detach()), "grads": g}


def leaves(tree) -> Dict[str, torch.Tensor]:
    """``{"node/key": tensor}`` of a two-level tree."""
    return {f"{n}/{k}": v for n, d in tree.items() for k, v in d.items()}


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             names: List[str], top: int = 1) -> tuple:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's:
    (the worst leaf's gap, the median leaf's gap, the ``top`` worst
    [leaf, gap, program norm, reference norm])."""
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    pn = {k: float(torch.linalg.vector_norm(prog[k].double()))
          for k in names}
    med = sorted(rn.values())[len(rn) // 2]
    def gap(k):
        return abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
    order = sorted(names, key=gap, reverse=True)
    return gap(order[0]), gap(order[len(order) // 2]), \
        [[k, gap(k), pn[k], rn[k]] for k in order[:top]]
