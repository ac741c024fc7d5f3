"""Readings that the limits of ``perfbench/limits/<cell>.json`` are set
from, on the card, many seeds in one process (set-up is long):

    python3 perfbench/calibrate.py serve --seeds 1,2,3 --control 4,5,6
    python3 perfbench/calibrate.py train --seeds 1,2,3 --control 4,5,6
    python3 perfbench/calibrate.py flips --seeds 1140090346

* the lower reading of each number: the program's sound runs, a short
  window each at the cell's own load;
* the upper: the control, the program's own lower-precision path where
  it has one (serving: the int8 PTQ deploy, ``engine/quantize.py``;
  training: the train step with ``compute_dtype=bfloat16``), and, for
  training, half of each batch left out (the mean over the rest);
* ``--kinds ref_tf32,ref_f32``: a second witness for training, the plain
  reference itself in the program's place with its convolutions in TF32
  or in float32, held against the reference in float32;
* ``flips``: for every pixel whose served label differs from the
  reference's, the reference's top-2 margin beside the body's logit
  error there, and where those pixels lie.

Prints one JSON line per run; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench import checks, serve, train, weights  # noqa: E402
from perfbench import run as bench, traffic as gen  # noqa: E402
from perfbench.reference import deeplab  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402


def int8_program(desc, params, state, frame_shape, device, pool=None):
    """The port's int8 PTQ deploy (calibrated on two frames of the pool)
    in the served function's place; the body's low-res logits are taken
    where K1 reads them."""
    from dcfp_tpu_torch.engine.quantize import make_int8_inference_fn
    from dcfp_tpu_torch.models.registry import build_model
    from dcfp_tpu_torch.ops import kernels
    from dcfp_tpu_torch.prune.pruner import apply_channel_cfg
    model = build_model(desc["model"], backbone=desc["backbone"],
                        backbone_para=desc["backbone_para"],
                        num_classes=desc["num_classes"],
                        align_corner=desc["align_corner"],
                        deepsup=desc["deepsup"])
    graph = apply_channel_cfg(model.graph, desc["channel_cfg"])
    calib = [pool[i].permute(0, 2, 3, 1).numpy() for i in range(2)]
    fn, bundle = make_int8_inference_fn(graph, params, state,
                                        calib_batches=calib, device=device)
    seen = {}
    k1 = kernels.resize_argmax_cm

    def grab(z, out_hw, ac):
        seen["logits"] = z
        return k1(z, out_hw, ac)

    def served(frame):
        kernels.resize_argmax_cm = grab
        try:
            return fn(bundle, frame.to(device).permute(0, 2, 3, 1))
        finally:
            kernels.resize_argmax_cm = k1

    dev_params = {c.name: {"kernel": params[c.name]["kernel"]}
                  for c in deeplab.convs(desc)}
    return served, seen, dev_params, graph


def serve_runs(spec, seeds, control, seconds, emit):
    dev = torch.device("cuda", 0)
    for kind, seed in [("program", s) for s in seeds] + \
            [("int8", s) for s in control]:
        program = None
        if kind == "int8":
            def program(desc, params, state, frame_shape, device):
                pool = gen.frames(spec["traffic"], seed, device)
                return int8_program(desc, params, state, frame_shape,
                                    device, pool)
        t0 = time.perf_counter()
        out = serve.run(spec["cell"]["name"], spec["desc"], spec["traffic"],
                        spec["limits"], seed, seconds, False, dev, t0,
                        program=program)
        emit({"kind": kind, "seed": seed, "found": out["found"],
              "requests": out["attempted"], "e2e": out["e2e"]})


def reference_run(spec, seed, dev, tf32, detail):
    """The second witness: the plain reference in the program's place,
    its convolutions in TF32 (``tf32``) or in float32, held against the
    reference in float32 by the cell's own comparison."""
    desc, traffic = spec["desc"], spec["traffic"]
    params, state = weights.make(desc, seed, dev)
    pool = gen.batches(traffic, desc, seed, dev)
    batches = [gen.batch(pool, i) for i in range(traffic["checked_steps"])]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = tf32
    twin = ref_train.Trainer(desc, params, state)
    run = {"p0": {k: v.float().cpu() for k, v in
                  ref_train.leaves(twin.params).items()},
           "bn0": {k: v.float().cpu() for k, v in
                   ref_train.leaves(twin.state).items()},
           "losses": []}
    dropout = torch.Generator().manual_seed(int(seed))
    for i, b in enumerate(batches):
        out = twin.step(b, dropout)
        run["losses"].append(out["loss"])
        if i == 0:
            run["grad1"] = {k: v.float().cpu() for k, v in
                            ref_train.leaves(out["grads"]).items()}
    run["params"] = {k: v.float().cpu() for k, v in
                     ref_train.leaves(twin.params).items()}
    run["bn"] = {k: v.float().cpu() for k, v in
                 ref_train.leaves(twin.state).items()}
    run["eic"] = {k: v.float().cpu() for k, v in twin.eic.items()}
    twin = None
    torch.backends.cudnn.allow_tf32 = False
    return checks.train_outputs(
        desc, run, ref_train.Trainer(desc, params, state), batches,
        torch.Generator().manual_seed(int(seed)), detail)


def train_runs(spec, seeds, control, emit,
               kinds=("bf16", "half_batch")):
    dev = torch.device("cuda", 0)
    traffic = spec["traffic"]
    n = traffic["global_batch"]
    runs = [("program", s) for s in seeds] + \
        [(k, s) for s in control for k in kinds]
    for kind, seed in runs:
        if kind in ("ref_tf32", "ref_f32"):
            detail = {}
            found = reference_run(spec, seed, dev, kind == "ref_tf32",
                                  detail)
            emit({"kind": kind, "seed": seed, "found": found,
                  "detail": detail})
            continue
        def program(desc, params, state, device, pool):
            loop, st = train.build(
                desc, params, state, device,
                torch.bfloat16 if kind == "bf16" else torch.float32)
            rows = slice(0, n // 2) if kind == "half_batch" else slice(None)
            return loop, st, gen.batch_stream(pool, rows)
        torch.backends.cuda.matmul.allow_tf32 = False
        # PyTorch's default, TF32 convs; "f32" runs the program without
        torch.backends.cudnn.allow_tf32 = kind != "f32"
        t0 = time.perf_counter()
        detail = {}
        out = train.run(spec["cell"]["name"], spec["desc"], traffic,
                        spec["limits"], seed, 0.0, False, dev, t0,
                        program=program, detail=detail)
        emit({"kind": kind, "seed": seed, "found": out["found"],
              "e2e": out["e2e"], "detail": detail})


def flips(spec, seeds, emit, path):
    """Every differing pixel of every sampled request: the reference's
    top-2 margin and the body's logit error there, over the frame's
    largest |logit|, in a file; the summary on the line."""
    dev = torch.device("cuda", 0)
    traffic = dict(spec["traffic"], sample_share=1.0, sample_max=4)
    rows = []

    def diagnose(i, b, up, logits, lab, flipped, scale):
        hw = up.shape[1:]
        mine = deeplab.upsample(logits.float(), hw,
                                spec["desc"]["align_corner"])[0]
        top2 = up.topk(2, 0)
        margin = (top2.values[0] - top2.values[1])[flipped]
        best = top2.indices[0][flipped]
        got = lab[flipped]
        d = (mine - up)[:, flipped].abs()
        e_best = d.gather(0, best[None])[0]
        e_got = d.gather(0, got[None])[0]
        err = torch.maximum(e_best, e_got)
        ys, xs = flipped.nonzero(as_tuple=True)
        gap = up.max(0).values[flipped] - up[:, flipped].gather(
            0, got[None])[0]
        h, w = hw
        def blocks(mask):
            yy, xx = mask.nonzero(as_tuple=True)
            grid = torch.zeros(8, 16, device=up.device)
            grid.index_put_((yy * 8 // h, xx * 16 // w),
                            torch.ones_like(yy, dtype=torch.float32),
                            accumulate=True)
            return grid.int().tolist()

        # where the reference itself is within the frame's largest
        # logit error of a tie: where rounding can flip a label
        ref_margin = up.topk(2, 0).values
        near = (ref_margin[0] - ref_margin[1]) <= 2 * float(
            (mine - up).abs().max())
        summary = {
            "frame": i, "flips": int(flipped.sum()),
            "share": float(flipped.float().mean()),
            "margin_over_scale_max": float(margin.max() / scale)
            if margin.numel() else 0.0,
            "err_over_scale_max": float(err.max() / scale)
            if err.numel() else 0.0,
            "margin_le_2err": float((margin <= 2 * err).float().mean())
            if margin.numel() else 1.0,
            "gap_le_2err": float((gap <= 2 * err).float().mean())
            if gap.numel() else 1.0,
            "logit_err_frame": float((mine - up).abs().max() / scale),
            "near_tie_share": float(near.float().mean()),
            "flips_by_block_8x16": blocks(flipped),
            "near_ties_by_block_8x16": blocks(near)}
        emit(dict(summary, kind="flips_frame"))
        for y, x, m, e in zip(ys.tolist(), xs.tolist(),
                              (margin / scale).tolist(),
                              (err / scale).tolist()):
            rows.append([i, y, x, m, e])

    for seed in seeds:
        t0 = time.perf_counter()
        out = serve.run(spec["cell"]["name"], spec["desc"], traffic,
                        spec["limits"], seed, 1.0, False, dev, t0,
                        diagnose=diagnose)
        emit({"kind": "flips_run", "seed": seed, "found": out["found"]})
    if path:
        with open(path, "w") as f:
            json.dump({"columns": ["frame", "y", "x", "margin_over_scale",
                                   "logit_err_over_scale"], "rows": rows}, f)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("what", choices=("serve", "train", "flips"))
    p.add_argument("--kinds", default="bf16,half_batch",
                   help="train controls: bf16, half_batch, f32; the "
                        "reference itself in TF32 or in float32, ref_tf32 "
                        "and ref_f32")
    p.add_argument("--cell")
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    p.add_argument("--pixels")
    a = p.parse_args()
    os.chdir(ROOT)
    cell = a.cell or {"serve": "serve.r101p50.b1", "flips":
                      "serve.r101p50.b1", "train": "train.r50p60.b8"}[a.what]
    spec = bench.cell_spec(bench.load_json("BENCHMARK.json"), cell)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    control = [int(s) for s in a.control.split(",") if s]
    sink = open(a.out, "a") if a.out else None

    def emit(d):
        line = json.dumps(d)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    if a.what == "serve":
        serve_runs(spec, seeds, control, a.seconds, emit)
    elif a.what == "train":
        train_runs(spec, seeds, control, emit, a.kinds.split(","))
    else:
        flips(spec, seeds, emit, a.pixels)


if __name__ == "__main__":
    main()
