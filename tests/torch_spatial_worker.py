"""One rank of a gloo group that ``tests/test_torch_spatial.py`` starts:
a ``(WORLD / 2) x 2`` mesh (1 x 2 or 2 x 2), image height split over
each data rank's 2 spatial ranks.  It imports only the port (and numpy),
runs every case in one go on the CPU and writes ``rank<r>.npz``.

    python tests/torch_spatial_worker.py PORT RANK WORLD OUT_DIR

Banded outputs are gathered whole before they are written, so every rank
writes whole arrays.  The inputs come from the seeded builders below,
which the test imports to feed the same numbers to the JAX package and
to the port's one-process runs.
"""

from __future__ import annotations

import datetime
import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "torch_parallel_worker", os.path.join(HERE, "torch_parallel_worker.py"))
P = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(P)

S = 2  # spatial ranks of a data rank
C = 5  # classes
HW = 32  # train crops
GLOBAL_BATCH = 4
OPT = P.OPT
LOSSES = P.LOSSES  # ce, ohem (its copy 4 x 4 an image), gsrl
IMG_HW = (41, 30)  # the Predictor's images: 21 rows after the stride 2
TILE = (24, 24)
MS = dict(scales=(0.75, 1.0), flip=True, align_corner=False, whole=False)
BP = {"os": 32, "mg_unit": [1, 1, 1], "inplanes": 64}
GRAPH_HW = (97, 70)  # 4 rows at os 32: one a rank over 4 spatial ranks
DROP = (3, 16, 33, 20)  # (N, C, H, W) through the dropout cases


def aspp_model(B, SM, rate=0.0, deepsup=True):
    """A tiny ASPP head: a stride-2 conv, a 3x3 conv, then a 1x1 branch,
    a dilation-6 branch (6 rows of halo past 8-row bands) and a global
    pool branch (a 1x1 map, its BN counted once a group) resized back,
    concatenated, dropout, a 1x1 classifier resized to the input;
    deepsup off the 3x3 conv."""
    b = B("tinyaspp")
    x = b.input("image")
    x = b.conv_bn_relu(x, "s", out_ch=8, kernel=3, stride=2)
    x = b.conv_bn_relu(x, "t", out_ch=8, kernel=3)
    a1 = b.conv_bn_relu(x, "a1", out_ch=6, kernel=1, padding=0)
    a2 = b.conv_bn_relu(x, "a2", out_ch=6, kernel=3, dilation=6)
    g = b.globalpool(x, "gp")
    g = b.conv_bn_relu(g, "gpc", out_ch=6, kernel=1, padding=0)
    g = b.resize(g, "gpup", like=a2, align_corners=True)
    z = b.concat([a1, a2, g], "cat")
    z = b.dropout(z, "drop", rate=rate)
    z = b.conv(z, "cls", out_ch=C, kernel=1, padding=0, bias=True)
    outs = [b.resize(z, "pred", to_input=True, align_corners=True)]
    if deepsup:
        d = b.conv(x, "dcls", out_ch=C, kernel=1, padding=0, bias=True)
        outs.append(b.resize(d, "deepsup", to_input=True,
                             align_corners=True))
    g = b.finish(outs)
    g.ignore_prune = []
    return SM(g, "tinyaspp", "none", C, True, deepsup, {}, {})


def eval_params(graph, seed):
    """np_params with the kernels scaled up and the classifier bias zero,
    so that the labels vary over the image (tests/test_torch_eval.py's
    rule)."""
    p, s = P.np_params(graph, seed)
    for v in p.values():
        if "kernel" in v:
            v["kernel"] *= np.float32(2.5)
    for name in ("cls", "last_conv.6"):
        if name in p:
            p[name]["bias"][:] = 0.0
    return p, s


def op_graph(B, case):
    """One op (or a pool and what reads it) on a 4-channel input: the
    op cases, each an (input NCHW shape, graph) pair."""
    b = B(case)
    x = b.input("image", channels=4)
    shape = (2, 4, 33, 20)
    if case == "conv_s1":
        y = b.conv(x, "op", out_ch=5, kernel=3, bias=True)
    elif case == "conv_s2":
        shape = (2, 4, 41, 21)
        y = b.conv(x, "op", out_ch=5, kernel=3, stride=2, bias=True)
    elif case == "conv_d9":  # halo 9 rows past bands of 9 and 8 rows
        shape = (1, 4, 17, 12)
        y = b.conv(x, "op", out_ch=5, kernel=3, dilation=9)
    elif case == "maxpool":
        y = b.maxpool(x, "op", kernel=3, stride=2, padding=1)
    elif case in ("resize_ac", "resize_hp"):
        shape = (2, 4, 17, 12)
        y = b.resize(x, "op", scale=2.0, align_corners=case == "resize_ac")
    elif case == "resize_down":
        y = b.resize(x, "op", scale=0.4, align_corners=False)
    elif case in ("resize_1x1_ac", "resize_1x1_hp"):
        g = b.globalpool(x, "gp")
        y = b.resize(g, "op", like=x, align_corners=case.endswith("ac"))
    elif case == "globalpool":
        y = b.globalpool(x, "op")
    elif case == "avgpool":
        y = b.adaptive_avgpool(x, "op", out_size=3)
    elif case in ("dropout", "dropout2d"):
        shape = DROP
        y = b.dropout(x, "op", rate=0.5, spatial=case == "dropout2d")
    else:
        raise ValueError(case)
    return shape, b.finish([y])


OP_CASES = ("conv_s1", "conv_s2", "conv_d9", "maxpool", "resize_ac",
            "resize_hp", "resize_down", "resize_1x1_ac", "resize_1x1_hp",
            "globalpool", "avgpool", "dropout", "dropout2d")


def op_input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def train_batch(seed=1):
    """The global batch of 4 x 32^2: ~5% ignored pixels, per-pixel GSRL
    weights."""
    r = np.random.default_rng(seed)
    img = r.standard_normal((GLOBAL_BATCH, HW, HW, 3)).astype(np.float32)
    ori = r.integers(0, C, (GLOBAL_BATCH, HW, HW)).astype(np.int32)
    ori[r.random(ori.shape) < 0.05] = 255
    weight = r.uniform(0.5, 2.0, ori.shape).astype(np.float32)
    return {"img": img, "label": {"ori": ori, "weight": weight}}


def images(seed=4):
    """One batch of 2 images a data rank (2 data ranks at most)."""
    r = np.random.default_rng(seed)
    return [r.standard_normal((2,) + IMG_HW + (3,)).astype(np.float32)
            for _ in range(2)]


def rows(batch, d, n_data):
    n = GLOBAL_BATCH // n_data
    return {k: rows(v, d, n_data) if isinstance(v, dict)
            else v[d * n:(d + 1) * n] for k, v in batch.items()}


def _whole(t, h, axis):
    """A banded output gathered whole (one held whole passes)."""
    from dcfp_tpu_torch.parallel import spatial
    return t if t.shape[-2] == h else spatial.gather_rows(t, h, axis)


def run(rank, world, out_dir):
    import torch

    from dcfp_tpu_torch.bridge import (eic_to_numpy, params_from_numpy,
                                       params_to_numpy)
    from dcfp_tpu_torch.engine import evaluator, optim, trainer
    from dcfp_tpu_torch.graph.apply import graph_apply
    from dcfp_tpu_torch.graph.ir import GraphBuilder
    from dcfp_tpu_torch.graph.shapes import infer_shapes
    from dcfp_tpu_torch.losses.criteria import build_criterions
    from dcfp_tpu_torch.models.heads import SegModel
    from dcfp_tpu_torch.models.registry import build_model
    from dcfp_tpu_torch.parallel import mesh as pmesh
    from dcfp_tpu_torch.parallel import spatial

    n_data = world // S
    out = {}
    # (a) the mesh
    mesh = pmesh.create_mesh(n_data, S, device="cpu")
    ax = mesh.spatial
    out["mesh"] = np.array([mesh.n_data, mesh.n_spatial, mesh.rank,
                            mesh.data_rank, mesh.spatial_rank, *ax.ranks])

    # (b) one op a graph, eval mode (dropout: train mode, seeded)
    for case in OP_CASES:
        shape, g = op_graph(GraphBuilder, case)
        p, s = params_from_numpy(*P.np_params(g), device="cpu")
        x = torch.from_numpy(op_input(shape))
        hw = shape[2:]
        drop = case.startswith("dropout")
        outs, _ = graph_apply(
            g, p, s, {"image": spatial.shard_rows(x, ax)},
            channels_first=True, input_hw=hw, spatial_axis=ax, train=drop,
            generator=torch.Generator().manual_seed(3) if drop else None)
        y = outs[g.outputs[0]]
        out[f"ops/{case}"] = _whole(
            y, infer_shapes(g, hw)[g.outputs[0]][0], ax).numpy()

    # (c) the deeplabv3 graph forward, eval mode
    dm = build_model("deeplabv3", backbone="resnet50", backbone_para=BP,
                     num_classes=C, align_corner=True, deepsup=True)
    p, s = params_from_numpy(*P.np_params(dm.graph, 6), device="cpu")
    x = torch.from_numpy(op_input((2, 3) + GRAPH_HW, 7))
    outs, _ = graph_apply(dm.graph, p, s,
                          {"image": spatial.shard_rows(x, ax)},
                          channels_first=True, input_hw=GRAPH_HW,
                          spatial_axis=ax)
    for k, v in outs.items():
        out[f"graph/{k}"] = _whole(v, GRAPH_HW[0], ax).numpy()

    # (d) one step per loss on the data rank's images, bands of them
    tm = aspp_model(GraphBuilder, SegModel)
    p0, s0 = P.np_params(tm.graph)
    mine = rows(train_batch(), mesh.data_rank, n_data)
    for name, crit in LOSSES.items():
        opt = optim.build_optimizer(**OPT)
        tp, ts = params_from_numpy(p0, s0, device="cpu")
        st = trainer.create_train_state(tm, tp, ts, opt, prune_type="dcfp",
                                        device="cpu")
        step = trainer.make_train_step(tm, build_criterions(**crit), opt,
                                       device="cpu", mesh=mesh)
        new, m = step(st, mine)
        np_p, np_s = params_to_numpy(new.params, new.bn_state)
        P.flat(f"step/{name}/params", np_p, out)
        P.flat(f"step/{name}/bn", np_s, out)
        P.flat(f"step/{name}/eic", eic_to_numpy(new.eic), out)
        out[f"step/{name}/loss"] = np.float64(m["loss"])
        out[f"step/{name}/grad_norm"] = np.float64(m["grad_norm"])
    # the GSRL step again, recomputing its forward in 3 segments in the
    # backward, with dropout: the exchanges replay in the same order
    drop_model = aspp_model(GraphBuilder, SegModel, rate=0.5)
    for remat in (0, 3):
        opt = optim.build_optimizer(**OPT)
        tp, ts = params_from_numpy(p0, s0, device="cpu")
        st = trainer.create_train_state(drop_model, tp, ts, opt,
                                        prune_type="dcfp", device="cpu")
        step = trainer.make_train_step(
            drop_model, build_criterions(**LOSSES["gsrl"]), opt,
            device="cpu", mesh=mesh, remat_segments=remat)
        new, _ = step(st, mine, torch.Generator().manual_seed(7))
        P.flat(f"remat{remat}/params", params_to_numpy(new.params,
                                                       new.bn_state)[0], out)

    # (e) the Predictor: whole logits and labels ("spatial" on 1 x 2,
    # "both" on 2 x 2), sliding and ms + flip, an evaluate
    em = aspp_model(GraphBuilder, SegModel, deepsup=False)
    ep, es = params_from_numpy(*eval_params(em.graph, 5), device="cpu")
    shard = "spatial" if n_data == 1 else "both"
    pred = evaluator.Predictor(em.graph, ep, es, mesh=mesh, shard=shard,
                               align_corner=True)
    img = images()[mesh.data_rank]
    out["pred/whole"] = pred.predict_whole(img).numpy()
    out["pred/labels"] = pred.predict_whole_labels(img).numpy()
    if n_data > 1:
        out["pred/sliding"] = pred.predict_sliding(img, TILE, C).numpy()
        out["pred/ms_flip"] = pred.predict_multiscale(
            img, TILE, num_classes=C, return_probs=True, **MS).numpy()
    items = P.eval_items()[mesh.data_rank::n_data]
    kw = dict(num_classes=P.C, align_corner=True, fps_warmup=0)
    out["eval/counts"] = np.bool_(pred.counts)
    out["eval/confusion"] = evaluator.evaluate(pred, items, **kw)["confusion"]
    out["eval/confusion_pipelined"] = evaluator.evaluate(
        pred, items, pipeline=True, **kw)["confusion"]

    # (f) fetch_rows' backward against gradcheck, in f64 (1 x 2 only)
    if n_data == 1:
        out["gradcheck"] = np.bool_(gradcheck_fetch(ax))

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def gradcheck_fetch(axis):
    """gradcheck of x -> gather(conv(fetch(shard(x)))): a stride-2,
    dilation-3 window over 9 rows (bands of 5 and 4, halos of 3 rows and
    a zero-filled border), with shard's and gather's backward making
    each rank's gradient the whole input's."""
    import torch
    import torch.nn.functional as F

    from dcfp_tpu_torch.parallel import spatial
    h, k, st, pad, dil = 9, 3, 2, 3, 3
    h_out = (h + 2 * pad - dil * (k - 1) - 1) // st + 1
    w = torch.from_numpy(op_input((2, 2, k, k), 8)).double()
    ranges = [spatial.window_rows(a, b, k, st, pad, dil)
              for a, b in axis.bands(h_out)]

    def f(x):
        y = spatial.fetch_rows(spatial.shard_rows(x, axis), ranges, h, axis)
        y = F.conv2d(y, w, stride=st, padding=(0, pad), dilation=dil)
        return spatial.gather_rows(y, h_out, axis)

    x = torch.from_numpy(op_input((1, 2, h, 4), 9)).double()
    x.requires_grad_(True)
    want = F.conv2d(x.detach(), w, stride=st, padding=pad, dilation=dil)
    assert torch.allclose(f(x).detach(), want, atol=1e-12)
    return torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-8)


def main():
    port, rank, world, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    import torch

    from dcfp_tpu_torch.parallel import distributed
    torch.set_num_threads(1)
    distributed.initialize(f"localhost:{port}", world, rank, device="cpu",
                           timeout=datetime.timedelta(seconds=60))
    run(rank, world, out_dir)


if __name__ == "__main__":
    main()
