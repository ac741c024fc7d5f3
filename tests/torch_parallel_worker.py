"""One rank of the 2-process gloo group that ``tests/test_torch_parallel.py``
starts: it imports only the port (and numpy), runs every case of the
test in one go on the CPU and writes ``rank<r>.npz`` into the output
directory.

    python tests/torch_parallel_worker.py PORT RANK OUT_DIR

The inputs come from the seeded builders below, which the test imports
to feed the same numbers to the JAX package and to the port's
one-process runs.
"""

from __future__ import annotations

import datetime
import math
import os
import signal
import sys

import numpy as np

WORLD = 2
C = 5  # classes
HW = 32  # train crops (the OHEM copy is 4x4 an image)
GLOBAL_BATCH = 4
OPT = dict(optim="sgd", learning_rate=0.05, momentum=0.9, num_steps=100)
LOSSES = {
    "ce": dict(loss_type="ce", ignore_label=255),
    # k = 1280 // 64 = 20 of the global batch's ~38 valid low-res pixels:
    # rank 0's 8 alone would keep everything (threshold 1)
    "ohem": dict(loss_type="ohem", ignore_label=255,
                 loss_para={"ohem_thres": 0.0, "ohem_keep": 1280}),
    "gsrl": dict(loss_type="gsrl", ignore_label=255),
}
DROP_STEPS = 3
EVAL_ITEMS = 5  # uneven strides: 3 on rank 0, 2 on rank 1
EVAL_HW = (17, 25)
STOP_AT = 3  # rank 1 signals itself while fetching step 3's batch


def model(B, SM, rate=0.0, deepsup=True):
    """A tiny DeepLab-like head: stride-2 conv+BN+ReLU, conv+BN+ReLU,
    spatial dropout, a 1x1 classifier resized to the input; deepsup off
    the same features."""
    b = B("tinyd")
    x = b.input("image")
    x = b.conv_bn_relu(x, "s", out_ch=8, kernel=3, stride=2)
    x = b.conv_bn_relu(x, "t", out_ch=8, kernel=3)
    z = b.dropout(x, "drop", rate=rate)
    z = b.conv(z, "cls", out_ch=C, kernel=1, padding=0, bias=True)
    outs = [b.resize(z, "pred", to_input=True, align_corners=True)]
    if deepsup:
        d = b.conv(x, "dcls", out_ch=C, kernel=1, padding=0, bias=True)
        outs.append(b.resize(d, "deepsup", to_input=True,
                             align_corners=True))
    g = b.finish(outs)
    g.ignore_prune = []
    return SM(g, "tinyd", "none", C, True, deepsup, {}, {})


def np_params(graph, seed=0):
    """Kaiming-uniform conv params and randomised BN params/statistics in
    the JAX package's layout (HWIO kernels)."""
    r = np.random.default_rng(seed)
    params, state = {}, {}
    for node in graph.toposorted():
        a = node.attrs
        if node.op == "conv":
            cin = a["in_ch"] // a["groups"]
            bound = 1.0 / math.sqrt(a["kernel"] ** 2 * cin)
            p = {"kernel": r.uniform(-bound, bound, (a["kernel"], a["kernel"],
                                                     cin, a["out_ch"]))}
            if a["bias"]:
                p["bias"] = r.uniform(-bound, bound, a["out_ch"])
            params[node.name] = {k: v.astype(np.float32)
                                 for k, v in p.items()}
        elif node.op == "bn":
            ch = a["channels"]
            params[node.name] = {
                "scale": r.uniform(0.5, 1.5, ch).astype(np.float32),
                "bias": r.normal(0.0, 0.1, ch).astype(np.float32)}
            state[node.name] = {
                "mean": r.normal(0.0, 0.1, ch).astype(np.float32),
                "var": r.uniform(0.5, 1.5, ch).astype(np.float32)}
    return params, state


def train_batch(seed=1):
    """The global batch of 4: rank 0's two images are ignore-label but for
    a 12x12 corner (2 x 4 valid pixels in OHEM's 4x4 copy), rank 1's have
    ~5% ignored pixels; per-pixel GSRL weights."""
    r = np.random.default_rng(seed)
    img = r.standard_normal((GLOBAL_BATCH, HW, HW, 3)).astype(np.float32)
    ori = r.integers(0, C, (GLOBAL_BATCH, HW, HW)).astype(np.int32)
    ori[2:][r.random((2, HW, HW)) < 0.05] = 255
    corner = np.zeros((HW, HW), bool)
    corner[:12, :12] = True
    ori[:2][:, ~corner] = 255
    weight = r.uniform(0.5, 2.0, (GLOBAL_BATCH, HW, HW)).astype(np.float32)
    return {"img": img, "label": {"ori": ori, "weight": weight}}


def drop_batches(seed=2):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(DROP_STEPS):
        img = r.standard_normal((GLOBAL_BATCH, HW, HW, 3)).astype(np.float32)
        ori = r.integers(0, C, (GLOBAL_BATCH, HW, HW)).astype(np.int32)
        ori[r.random(ori.shape) < 0.05] = 255
        weight = r.uniform(0.5, 2.0, ori.shape).astype(np.float32)
        out.append({"img": img, "label": {"ori": ori, "weight": weight}})
    return out


def eval_items(seed=3):
    r = np.random.default_rng(seed)
    items = []
    for i in range(EVAL_ITEMS):
        img = r.standard_normal((1,) + EVAL_HW + (3,)).astype(np.float32)
        label = r.integers(0, C, (1,) + EVAL_HW)
        label[r.random(label.shape) < 0.1] = 255
        items.append({"img": img, "label": label,
                      "img_meta": [{"name": f"im{i}"}]})
    return items


def rows(batch, rank):
    """Rank ``rank``'s rows of a global batch (nested dicts walked)."""
    n = GLOBAL_BATCH // WORLD
    return {k: rows(v, rank) if isinstance(v, dict)
            else v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def flat(prefix, tree, out):
    for n, d in tree.items():
        if isinstance(d, dict):
            flat(f"{prefix}/{n}", d, out)
        else:
            out[f"{prefix}/{n}"] = np.asarray(d)


def run(rank, out_dir):
    import torch

    from dcfp_tpu_torch.bridge import (eic_to_numpy, params_from_numpy,
                                       params_to_numpy)
    from dcfp_tpu_torch.engine import evaluator, optim, trainer
    from dcfp_tpu_torch.graph.ir import GraphBuilder
    from dcfp_tpu_torch.losses.criteria import build_criterions
    from dcfp_tpu_torch.models.heads import SegModel
    from dcfp_tpu_torch.parallel import distributed, mesh

    out = {}
    # (e) the mesh and its helpers
    out["e/world"] = np.int64(mesh.world())
    out["e/rank"] = np.int64(distributed.process_index())
    pm = distributed.create_pod_mesh(n_spatial=1, device="cpu")
    out["e/pod_mesh"] = np.array([pm.n_data, pm.n_spatial, pm.rank])
    pm = distributed.create_pod_mesh(n_spatial=1, dcn_data_parallel=2,
                                     device="cpu")
    out["e/pod_mesh_dcn2"] = np.array([pm.n_data, pm.n_spatial])
    sm = distributed.create_pod_mesh(n_spatial=2, device="cpu")
    out["e/pod_mesh_spatial"] = np.array([sm.n_data, sm.n_spatial, sm.rank,
                                          sm.data_rank, sm.spatial_rank])
    raised = []
    for kw in (dict(n_spatial=3), dict(n_spatial=1, dcn_data_parallel=3)):
        try:
            distributed.create_pod_mesh(device="cpu", **kw)
            raised.append(False)
        except ValueError:
            raised.append(True)
    out["e/validation_raised"] = np.array(raised)
    s = distributed.process_batch_slice(8)
    out["e/batch_slice"] = np.array([s.start, s.stop])
    mine = {"a": {"w": torch.full((3,), float(rank + 1))}}
    out["e/replicated"] = mesh.replicate_tree(pm, mine)["a"]["w"].numpy()
    out["e/gather"] = mesh.all_gather(torch.tensor([float(rank)])).numpy()
    x = torch.tensor([1.0 + rank], requires_grad=True)
    y = mesh.sum_across(x * x)  # d/dx_r of sum_r' (sum_r'' x^2) = 2 W x_r
    (g,) = torch.autograd.grad(y.sum(), x)
    out["e/sum_and_grad"] = np.array([float(y.detach()), float(g)])

    # (a) one step per loss on rank r's half of the global batch
    tm = model(GraphBuilder, SegModel)
    p0, s0 = np_params(tm.graph)
    half = rows(train_batch(), rank)
    for name, crit in LOSSES.items():
        opt = optim.build_optimizer(**OPT)
        tp, ts = params_from_numpy(p0, s0, device="cpu")
        st = trainer.create_train_state(tm, tp, ts, opt, prune_type="dcfp",
                                        device="cpu")
        step = trainer.make_train_step(tm, build_criterions(**crit), opt,
                                       device="cpu")
        new, m = step(st, half)
        np_p, np_s = params_to_numpy(new.params, new.bn_state)
        flat(f"a/{name}/params", np_p, out)
        flat(f"a/{name}/bn", np_s, out)
        flat(f"a/{name}/eic", eic_to_numpy(new.eic), out)
        out[f"a/{name}/loss"] = np.float64(m["loss"])
        out[f"a/{name}/grad_norm"] = np.float64(m["grad_norm"])

    # (b) three GSRL + EIC steps with spatial dropout 0.5
    dm = model(GraphBuilder, SegModel, rate=0.5)
    opt = optim.build_optimizer(**OPT)
    tp, ts = params_from_numpy(p0, s0, device="cpu")
    st = trainer.create_train_state(dm, tp, ts, opt, prune_type="dcfp",
                                    device="cpu")
    step = trainer.make_train_step(dm, build_criterions(**LOSSES["gsrl"]),
                                   opt, device="cpu")
    gen = torch.Generator().manual_seed(7)
    for batch in drop_batches():
        st, m = step(st, rows(batch, rank), gen)
    np_p, np_s = params_to_numpy(st.params, st.bn_state)
    flat("b/params", np_p, out)
    flat("b/bn", np_s, out)
    out["b/loss"] = np.float64(m["loss"])

    # (c) sharded eval: this rank's stride of the items, through the
    # label path (K1's plain version on the CPU)
    em = model(GraphBuilder, SegModel, deepsup=False)
    ep, es = params_from_numpy(*np_params(em.graph, 5), device="cpu")
    pred = evaluator.Predictor(em.graph, ep, es, mesh=pm, shard="data",
                               align_corner=True)
    items = eval_items()[rank::WORLD]
    kw = dict(num_classes=C, align_corner=True, fps_warmup=0)
    out["c/n_items"] = np.int64(len(items))
    out["c/confusion"] = evaluator.evaluate(pred, items, **kw)["confusion"]
    out["c/confusion_pipelined"] = evaluator.evaluate(
        pred, items, pipeline=True, **kw)["confusion"]
    result = os.path.join(out_dir, "result.txt")
    evaluator.evaluate(pred, items, result_file=result, **kw)

    # (d) the stop consensus: SIGTERM to rank 1 only
    snaps = []

    def batches():
        i = 0
        while True:
            if rank == 1 and i == STOP_AT:
                os.kill(os.getpid(), signal.SIGTERM)
            yield rows(train_batch(), rank)
            i += 1

    opt = optim.build_optimizer(**OPT)
    tp, ts = params_from_numpy(p0, s0, device="cpu")
    st = trainer.create_train_state(tm, tp, ts, opt, device="cpu")
    loop = trainer.TrainLoop(
        model=tm, criterion=build_criterions(**LOSSES["ce"]), optimizer=opt,
        num_steps=50, lr_schedule=opt.schedule, log_every=2,
        snapshot_hook=lambda st, step: snaps.append(step),
        handle_signals=True,
        metrics_file=os.path.join(out_dir, f"metrics{rank}.jsonl"))
    out["d/stop_step"] = np.int64(loop.run(st, batches(), device="cpu").step)
    out["d/snapshots"] = np.array(snaps, np.int64)

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def main():
    port, rank, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import torch

    from dcfp_tpu_torch.parallel import distributed
    torch.set_num_threads(1)
    distributed.initialize(f"localhost:{port}", WORLD, rank, device="cpu",
                           timeout=datetime.timedelta(seconds=60))
    run(rank, out_dir)


if __name__ == "__main__":
    main()
