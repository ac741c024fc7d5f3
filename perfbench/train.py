"""Training cells: the finetune step of ``scripts/cs/finetune.sh`` at the
recipe's global batch, driven through the port's ``engine/trainer.
TrainLoop`` (``make_train_step``: GSRL with deep supervision, EIC,
SGD with momentum, weight decay and the warm-up/poly schedule, seeded
dropout) on compact batches that ``expand_batch`` widens on the device.

Set-up builds one train state and one loop, and drives them from the
seed through the first ``checked_steps`` steps on distinct batches of
the pool; the window continues the same state and loop.  The loop syncs
once at the end of every ``chunk_steps`` steps (its log boundary), and
the window ends at the first boundary past ``--seconds``; the rate is
all the images of all those steps over all that time.

After the window the plain reference (:mod:`perfbench.reference.train`,
float32, TF32 off) takes the same first steps from the same weights,
batches and dropout generator, and :func:`perfbench.checks.
train_outputs` holds the program's against them.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

from perfbench import arith, checks, traffic as gen, weights
from perfbench.reference import train as ref_train
from perfbench.trace import Tracer, phase


def build(desc: dict, params, state, device,
          compute_dtype=torch.float32):
    """(loop, first train state) of the program at the configuration's
    widths, as ``cli/train.py`` builds them for a finetune."""
    from dcfp_tpu_torch.engine.optim import build_optimizer
    from dcfp_tpu_torch.engine.trainer import TrainLoop, create_train_state
    from dcfp_tpu_torch.losses.criteria import build_criterions
    from dcfp_tpu_torch.models.registry import build_model
    from dcfp_tpu_torch.prune.pruner import apply_channel_cfg
    ft = desc["finetune"]
    model = build_model(desc["model"], backbone=desc["backbone"],
                        backbone_para=desc["backbone_para"],
                        num_classes=desc["num_classes"],
                        align_corner=desc["align_corner"],
                        deepsup=desc["deepsup"])
    model.graph = apply_channel_cfg(model.graph, desc["channel_cfg"])
    opt = build_optimizer(optim=ft["optim"], learning_rate=ft["learning_rate"],
                          momentum=ft["momentum"],
                          weight_decay=ft["weight_decay"],
                          num_steps=ft["num_steps"], power=ft["power"],
                          warmup=ft["warmup"])
    crit = build_criterions(ft["loss"], ignore_label=desc["ignore_label"],
                            loss_para={"ds_weight": ft["ds_weight"]})
    norm = ft["normalize"]
    loop = TrainLoop(model=model, criterion=crit, optimizer=opt,
                     num_steps=0, lr_schedule=opt.schedule,
                     log_every=10 ** 9, prune_type=ft["prune_type"],
                     eic_r=ft["eic_r"], compute_dtype=compute_dtype,
                     normalize=(tuple(norm["mean"]), tuple(norm["std"])),
                     ignore_label=desc["ignore_label"])
    first = create_train_state(model, params, state, opt,
                               prune_type=ft["prune_type"], device=device)
    return loop, first


def _host(tree):
    return {k: v.detach().float().cpu() for k, v in
            ref_train.leaves(tree).items()}


def steps(loop, st, stream, generator, n, device):
    """``n`` more steps of ``loop`` from ``st``; ends in one sync."""
    loop.num_steps = st.step + n
    return loop.run(st, stream, generator, start_step=st.step,
                    device=device)


def first_steps(desc, traffic, loop, st, stream, generator, device):
    """The checked steps; returns (state, what the check reads)."""
    wd = desc["finetune"]["weight_decay"]
    p0 = ref_train.leaves(st.params)
    run = {"p0": {k: v.detach().float().cpu() for k, v in p0.items()},
           "bn0": _host(st.bn_state)}
    with tempfile.TemporaryDirectory() as tmp:
        loop.metrics_file = os.path.join(tmp, "steps.jsonl")
        loop.log_every = 1
        st = steps(loop, st, stream, generator, 1, device)
        trace = ref_train.leaves(st.opt_state["trace"])
        run["grad1"] = {k: (trace[k] - wd * p0[k]).float().cpu()
                        for k in trace}
        st = steps(loop, st, stream, generator,
                   traffic["checked_steps"] - 1, device)
        run["losses"] = []
        with open(loop.metrics_file) as f:
            run["losses"] = [json.loads(line)["loss"] for line in f]
        loop.metrics_file, loop.log_every = None, 10 ** 9
    run["params"] = _host(st.params)
    run["bn"] = _host(st.bn_state)
    run["eic"] = {k: v.float().cpu() for k, v in st.eic.items()}
    return st, run


def run(cell: str, desc: dict, traffic: dict, limits: dict, seed: int,
        seconds: float, trace: bool, device: torch.device, t_start: float,
        program=None, detail=None) -> dict:
    """One run of a training cell; ``program(desc, params, state,
    device) -> (loop, state, feed)`` replaces :func:`build` and the
    plain feed (the tests plant faults through it)."""
    cuda = device.type == "cuda"
    phase("imports", t_start)
    params, state = weights.make(desc, seed, device)
    phase("weights", t_start)
    pool = gen.batches(traffic, desc, seed, device)
    phase("pool", t_start)
    if program is None:
        loop, st = build(desc, params, state, device)
        feed = gen.batch_stream(pool)
    else:
        loop, st, feed = program(desc, params, state, device, pool)
    phase("build", t_start)
    dropout = torch.Generator().manual_seed(int(seed))
    st, checked = first_steps(desc, traffic, loop, st, feed, dropout,
                              device)
    _sync(cuda)
    setup_s = time.perf_counter() - t_start

    done = 0
    t0 = time.perf_counter()
    while True:
        st = steps(loop, st, feed, dropout, traffic["chunk_steps"], device)
        done += traffic["chunk_steps"]
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    tracer = Tracer(trace)
    if trace:  # after the measured window, so that it costs it nothing
        with tracer.window():
            st = steps(loop, st, feed, dropout, traffic["trace_steps"],
                       device)
    n_img = done * traffic["global_batch"]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    st = loop = feed = None
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    reference = ref_train.Trainer(desc, params, state)
    found = checks.train_outputs(
        desc, checked, reference,
        [gen.batch(pool, i) for i in range(traffic["checked_steps"])],
        torch.Generator().manual_seed(int(seed)), detail)
    hw = tuple(traffic["crop_hw"])
    out = {
        "attempted": done, "failed": 0, "setup_s": setup_s, "peak": peak,
        "e2e": {"train_img_per_s": n_img / window_s,
                "train_peak_gb": peak / 1e9, "setup_s": setup_s},
        "found": found, "limits": limits,
        "ctx": {"flops_per_unit": 3 * 2 * arith.macs(
                    desc, hw, traffic["global_batch"]),
                "peak_flops": arith.TF32_FLOPS, "unit_s": window_s / done},
    }
    if trace:
        out["window"] = tracer.result(traffic["trace_steps"])
    return out


def _sync(cuda: bool):
    if cuda:
        torch.cuda.synchronize()
