"""The comparisons that decide ``correct``: what the program produced in
the window against the plain reference, each number to be held under
its limit (``perfbench/limits/<cell>.json``, with the readings each was
set from in ``PERF.md``).

Serving (per sampled request; the worst over the sample):

* ``logit_rms_x``: the L2 norm of the error of the body's
  low-resolution logits against the float32 reference's, over the L2
  norm of the error that the same reference makes when it runs in
  bfloat16 (weights, statistics and activations; its "bf16 twin") on the
  same frame.  How far a random network's logits move under bf16
  rounding depends on its weights, by 2x from seed to seed; the ratio
  takes that out, so it reads about 1 for a sound bf16 program on every
  seed and several times that for one computing in less.
* ``logit_err_x``: the same with the largest |error| in place of the
  L2 norm.
* ``logit_err``, ``logit_rms``: the largest |error| and the L2 norm of
  the error over the largest |reference logit| and the reference's L2
  norm (printed).
* ``tail_off``: K1's stage by itself: pixels whose served label lies
  more than 2 bf16 ulps of the best value below the best, in the plain
  bilinear resize (float32) of the low-resolution logits the same
  request served.  K1's contract is the argmax of the resized values
  rounded to bf16, first maximum winning, so a sound tail reads 0
  (exact).
* ``label_gap``: the widest gap by which the value of a served label
  lies below the best value at its pixel, both read from the
  reference's logits bilinearly resized to the frame, over the same
  scale (printed: labels that bf16 rounding flipped at near-ties lie a
  logit error below the best, which ``logit_err`` holds).
* ``widths_off``: convs whose width in the program's prepared weights
  differs from the configuration's (exact, 0).
* ``k1_launches_off``: |K1 launches in the window - requests| (exact).

Training: see :func:`train_outputs`.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.reference import deeplab
from perfbench.reference import train as ref_train


def widths_off(desc: dict, graph, dev_params) -> int:
    want = {c.name: (c.cout, c.cin) for c in deeplab.convs(desc)}
    have = {n.name for n in graph.conv_nodes()}
    off = len(have ^ set(want))
    for name, (cout, cin) in want.items():
        if name in have:
            off += tuple(dev_params[name]["kernel"].shape[:2]) != (cout, cin)
    return off


def serve_outputs(desc: dict, params, state, pool, kept, hw, device,
                  diagnose=None) -> Dict[str, float]:
    """``kept``: (pool index, host labels (N, H, W) uint8, the body's
    logits (N, C, h, w)) of each sampled request."""
    found = {"logit_rms_x": 0.0, "logit_err_x": 0.0, "logit_err": 0.0,
             "logit_rms": 0.0, "tail_off": 0.0, "label_gap": 0.0,
             "flip_share": 0.0}
    refs: Dict[int, tuple] = {}
    half = ({n: {k: v.to(torch.bfloat16) for k, v in d.items()}
             for n, d in params.items()},
            {n: {k: v.to(torch.bfloat16) for k, v in d.items()}
             for n, d in state.items()})
    norm = torch.linalg.vector_norm
    with torch.no_grad():
        for i, labels, logits in kept:
            if i not in refs:
                frame = pool[i].to(device)
                ref = deeplab.forward(desc, params, state, frame)[0]["pred"]
                twin = deeplab.forward(desc, *half, frame.to(
                    torch.bfloat16))[0]["pred"].float() - ref
                refs[i] = (ref, twin)
            ref, twin = refs[i]
            scale = float(ref.abs().max())
            err = (logits.float() - ref).abs()
            found["logit_err"] = max(found["logit_err"],
                                     float(err.max()) / scale)
            found["logit_rms"] = max(found["logit_rms"],
                                     float(norm(err) / norm(ref)))
            found["logit_err_x"] = max(found["logit_err_x"], float(
                err.max() / twin.abs().max()))
            found["logit_rms_x"] = max(found["logit_rms_x"],
                                       float(norm(err) / norm(twin)))
            for b in range(ref.shape[0]):
                up = deeplab.upsample(ref[b:b + 1], hw,
                                      desc["align_corner"])[0]
                lab = labels[b].to(device).long()
                best = up.max(0)
                picked = up.gather(0, lab[None])[0]
                found["label_gap"] = max(
                    found["label_gap"],
                    float((best.values - picked).max()) / scale)
                flips = lab != best.indices
                found["flip_share"] = max(found["flip_share"],
                                          float(flips.float().mean()))
                found["tail_off"] += tail_off(logits[b:b + 1], lab, hw,
                                              desc["align_corner"])
                if diagnose is not None:
                    diagnose(i, b, up, logits[b:b + 1], lab, flips, scale)
                del up
    return found


def tail_off(logits, labels, hw, align_corners) -> float:
    """Pixels whose label lies more than 2 bf16 ulps of the best value
    below the best, in the float32 bilinear resize of ``logits``
    (1, C, h, w)."""
    up = deeplab.upsample(logits, hw, align_corners)[0]
    best = up.max(0).values
    picked = up.gather(0, labels[None])[0]
    ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(
        torch.floor(torch.log2(best.abs().clamp_min(1e-30))))
    return float(((best - picked) > 2 * ulp).sum())


def train_outputs(desc: dict, run: dict, ref_trainer, batches: List[dict],
                  generator, detail=None) -> Dict[str, float]:
    """Hold the program's first steps against the reference's.

    ``run``: the program's ``losses`` (one per step), ``grad1`` (the
    gradient the optimizer got at step 1, from its momentum after it),
    and after the last step ``params``, ``bn`` and ``eic``, each
    ``{"node/key": tensor}``; ``p0`` and ``bn0`` the starting values.

    * ``loss_gap``: the worst step's |program - reference| loss over the
      reference's.
    * ``grad_*``, ``change_*``, ``bn_*``, ``eic_*``: each leaf's gap
      between the program's norm and the reference's (not the norm of
      their difference) over the larger of that leaf's reference norm
      and the median leaf's, of the first gradient, of the parameters'
      change over the steps, of the BN running statistics' change, of
      the EIC scores; ``_worst`` is the worst leaf's gap, ``_median``
      the median leaf's.  The change leaves out the leaves whose
      reference gradient is under a thousandth of the median leaf's
      (they move by rounding alone under the optimizer).

    ``detail``, a dict, receives each number's worst leaves and the
    losses of both sides.
    """
    detail = {} if detail is None else detail
    losses, grad1 = [], None
    for i, b in enumerate(batches):
        out = ref_trainer.step(b, generator)
        losses.append(out["loss"])
        if i == 0:
            grad1 = {k: v.float().cpu()
                     for k, v in ref_train.leaves(out["grads"]).items()}
    found = {"loss_gap": max(abs(p - r) / abs(r) for p, r in
                             zip(run["losses"], losses))}
    detail["losses"] = [run["losses"], losses]

    def both(key, prog, ref, names):
        worst, median, top = ref_train.norm_gap(prog, ref, names, 5)
        found[f"{key}_worst"], found[f"{key}_median"] = worst, median
        detail[key] = top

    names = sorted(grad1)
    both("grad", run["grad1"], grad1, names)
    gn = {k: float(torch.linalg.vector_norm(grad1[k].double()))
          for k in names}
    med = sorted(gn.values())[len(gn) // 2]
    moved = [k for k in names if gn[k] >= 1e-3 * med]
    ref_p = {k: v.cpu() for k, v in ref_train.leaves(
        ref_trainer.params).items()}
    both("change", {k: run["params"][k] - run["p0"][k] for k in moved},
         {k: ref_p[k] - run["p0"][k] for k in moved}, moved)
    ref_bn = {k: v.cpu() for k, v in ref_train.leaves(
        ref_trainer.state).items()}
    bn_names = sorted(ref_bn)
    both("bn", {k: run["bn"][k] - run["bn0"][k] for k in bn_names},
         {k: ref_bn[k] - run["bn0"][k] for k in bn_names}, bn_names)
    both("eic", run["eic"], {k: v.cpu() for k, v in ref_trainer.eic.items()},
         sorted(ref_trainer.eic))
    return found


def held(found: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit is within it."""
    return all(found[k] <= v for k, v in limits.items())
