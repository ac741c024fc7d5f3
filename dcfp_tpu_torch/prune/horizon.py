"""EIC signal against the training horizon: does the pruning decision
agree between two arithmetics as well as a run agrees with itself?
Port of ``tools/exp_eic_horizon.py`` (its statistics) with the synthetic
long-tail stream of ``tests/test_convergence.py``.

DCFP prunes on an EMA of the EIC score (r = 0.999, a memory of about
1,000 steps) after thousands of pretrain steps.  f32 accumulation-order
noise decorrelates per-channel gradients within a few steps, so no two
runs agree channel by channel at such horizons: a run is held against a
reference next to its self-noise floor, the same run from an init
scaled by 1 + 1e-6 (``perturb``).  At each checkpoint a row holds

  * the within-layer EIC correlation (Pearson, and Spearman on ranks)
    of the run against the reference and against the floor,
  * the between-layer structure (correlation of the layers' mean
    scores) that the global threshold reads, and
  * the agreement of the DCFP keep-masks (global_percent 0.5,
    layer_keep 0.02, conv_deepsup excepted: the Cityscapes recipe's
    shape) against the reference's and the floor's;

``check_rows`` applies the gates of ``tests/test_eic_horizon.py``.

On the card (``card_horizon``) the flagship trains three times on the
same stream, with cuDNN's deterministic algorithms: f32 (TF32 off), f32
from the perturbed init (the floor), and with TF32 on for convolutions
and matmuls, which is at least what ``cli.train`` runs (PyTorch's
default: cuDNN TF32 on).  Its ``rows`` hold TF32 against f32 and against
the floor (``check_card`` applies ``check_rows``), its
``rows_f32_own_floor`` f32 against TF32 next to f32's own floor.  Run it
as

    python -m dcfp_tpu_torch.prune.horizon --steps 200 --hw 257 \\
        --batch 2 --out horizon.json

Against the JAX package on the CPU: ``tests/torch_eic_horizon.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dcfp_tpu_torch.device import DeviceLike, resolve_device
from dcfp_tpu_torch.engine.optim import build_optimizer
from dcfp_tpu_torch.engine.trainer import create_train_state, make_train_step
from dcfp_tpu_torch.graph.apply import init_graph
from dcfp_tpu_torch.graph.ir import Graph
from dcfp_tpu_torch.losses.criteria import build_criterions
from dcfp_tpu_torch.models.heads import SegModel
from dcfp_tpu_torch.models.registry import build_model
from dcfp_tpu_torch.prune.eic import prunable_bn_names
from dcfp_tpu_torch.prune.pruner import DCFPPruner
from dcfp_tpu_torch.prune.trace import trace_topology
from dcfp_tpu_torch.utils.profiling import card_name_and_power

# the pretrain recipe, shrunk (tests/test_convergence.py:55-68)
C = 19
IGNORE = 255
LR, MOMENTUM, WD, POWER = 0.01, 0.9, 5e-4, 0.9
EIC_R = 0.999
PRUNE_PERCENT = 0.5
LAYER_KEEP = 0.02
CHECKPOINTS = (50, 100, 200, 400, 700, 1000, 1400, 2000, 2800)

# long-tail class prior: geometric decay, head class ~60x the tail class
FREQ = 0.72 ** np.arange(C)
FREQ /= FREQ.sum()

Snapshots = Dict[int, Dict[str, np.ndarray]]


# -- the stream ---------------------------------------------------------------

def _palette(rng):
    return rng.uniform(-1.0, 1.0, (C, 3)).astype(np.float32)


def _gen_sample(rng, palette, hw):
    """One synthetic long-tail sample: a blobby label map and a
    class-colored noisy image, 4% of its pixels ignored."""
    lab = np.full((hw, hw), rng.choice(C, p=FREQ), np.int64)
    for _ in range(4):
        c = rng.choice(C, p=FREQ)
        h = rng.integers(hw // 5, hw // 2)
        w = rng.integers(hw // 5, hw // 2)
        y = rng.integers(0, hw - h)
        x = rng.integers(0, hw - w)
        lab[y:y + h, x:x + w] = c
    img = palette[lab] + 0.35 * rng.standard_normal(
        (hw, hw, 3)).astype(np.float32)
    lab[rng.random((hw, hw)) < 0.04] = IGNORE
    return img, lab


def make_pretrain_batches(n, seed=11, hw=33, batch=2):
    """``n`` batches of the i.i.d. long-tail stream, plain labels."""
    rng = np.random.default_rng(seed)
    palette = _palette(np.random.default_rng(3))
    out = []
    for _ in range(n):
        imgs, labs = zip(*[_gen_sample(rng, palette, hw)
                           for _ in range(batch)])
        out.append({"img": np.stack(imgs), "label": np.stack(labs)})
    return out


# -- the runs -----------------------------------------------------------------

def build_horizon_model(inplanes: int = 64) -> SegModel:
    """DeepLabV3-R50, os 8, mg [1,2,4], 19 classes, align_corner,
    deepsup, every dropout at rate 0.  ``inplanes`` 64 is the
    convergence test's cut, 128 the flagship's width."""
    model = build_model("deeplabv3", backbone="resnet50",
                        backbone_para={"os": 8, "mg_unit": [1, 2, 4],
                                       "inplanes": inplanes},
                        num_classes=C, align_corner=True, deepsup=True)
    for node in model.graph.toposorted():
        if node.op == "dropout":
            node.attrs["rate"] = 0.0
    return model


def perturb(params, eps: float = 1e-6):
    """The floor's init: every float param scaled by 1 + eps."""
    return {n: {k: v * (1 + eps) if v.is_floating_point() else v
                for k, v in d.items()} for n, d in params.items()}


def checkpoints_for(total: int) -> List[int]:
    """The ladder of ``CHECKPOINTS`` up to ``total``, ending at it."""
    cps = [c for c in CHECKPOINTS if c <= total]
    return cps if cps and cps[-1] == total else cps + [total]


class Run(NamedTuple):
    eic: Snapshots  # step -> {bn: float64 scores}
    losses: List[float]  # one a step
    median_step_ms: float  # host clock, each step ending in a sync


@contextlib.contextmanager
def _cuda_arithmetic(dev: torch.device, tf32: bool):
    """TF32 on or off for cuDNN and the matmuls, and cuDNN's
    deterministic algorithms: the floor is the distance a 1e-6 init
    perturbation makes, so a run must repeat bit for bit (with its
    default f32 algorithms an H100 run does not, and the floor moved by
    ~0.04 Pearson between two calls of the same runs)."""
    if dev.type != "cuda":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32 = matmul.allow_tf32 = tf32
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = saved


def run_with_snapshots(model: SegModel, params, bn, batches, num_steps: int,
                       checkpoints: Sequence[int], *,
                       device: DeviceLike = None, tf32: bool = False) -> Run:
    """Pretrain ``model`` from ``params`` / ``bn`` for ``num_steps`` of
    ``batches``: CE + EIC (r 0.999), SGD lr 0.01 with the poly schedule,
    momentum 0.9, wd 5e-4, no warmup, no dropout.  The EIC is kept at
    each of ``checkpoints``.  On CUDA, ``tf32`` sets cuDNN's and the
    matmuls' TF32 for the loop and cuDNN runs its deterministic
    algorithms (all restored after); the CPU has neither."""
    dev = resolve_device(device)
    opt = build_optimizer(optim="sgd", learning_rate=LR, momentum=MOMENTUM,
                          weight_decay=WD, num_steps=num_steps, power=POWER,
                          warmup=0)
    state = create_train_state(model, params, bn, opt, prune_type="dcfp",
                               device=dev)
    step = make_train_step(model, build_criterions("ce", ignore_label=IGNORE),
                           opt, eic_r=EIC_R, device=dev)
    want = set(checkpoints)
    snaps: Snapshots = {}
    losses, secs = [], []
    with _cuda_arithmetic(dev, tf32):
        for i, batch in enumerate(itertools.islice(batches, num_steps)):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            secs.append(time.perf_counter() - t0)
            if i + 1 in want:
                snaps[i + 1] = {k: v.detach().cpu().double().numpy()
                                for k, v in state.eic.items()}
    return Run(snaps, losses, float(np.median(secs)) * 1e3)


# -- the statistics (tools/exp_eic_horizon.py:107-135, 186-188) ---------------

def _rank(x):
    r = np.empty(x.size, np.float64)
    r[np.argsort(x, kind="stable")] = np.arange(x.size, dtype=np.float64)
    return r


def within_layer_corr(a, b, names, rank=False):
    """Mean over layers of the correlation of two runs' channel scores
    (Spearman with ``rank``); layers constant in either run are left
    out."""
    corrs = []
    for n in names:
        x = np.asarray(a[n], np.float64).ravel()
        y = np.asarray(b[n], np.float64).ravel()
        if x.std() > 1e-12 and y.std() > 1e-12:
            if rank:
                x, y = _rank(x), _rank(y)
            corrs.append(float(np.corrcoef(x, y)[0, 1]))
    return float(np.mean(corrs))


def layer_mean_corr(a, b, names):
    """Correlation of the two runs' per-layer mean scores."""
    return float(np.corrcoef([np.asarray(a[n]).mean() for n in names],
                             [np.asarray(b[n]).mean() for n in names])[0, 1])


def masks_for(eic, graph: Graph, topo):
    pruner = DCFPPruner({k: np.asarray(v, np.float32) for k, v in
                         eic.items()}, global_percent=PRUNE_PERCENT,
                        layer_keep=LAYER_KEEP,
                        except_start_keys=["conv_deepsup"])
    return pruner.space_masks(graph, topo)


def mask_agreement(ma, mb):
    agree = np.concatenate([ma[k] == mb[k] for k in sorted(ma)])
    return float(agree.mean())


def horizon_rows(run: Snapshots, ref: Snapshots, floor: Snapshots,
                 graph: Graph, checkpoints: Sequence[int]) -> List[dict]:
    """One row a checkpoint: ``run`` against ``ref`` (``*_ref``) and
    against ``floor``, a run from ``perturb(params)`` (``*_floor``), as
    ``tools/exp_eic_horizon.py`` makes them.  Every statistic is
    symmetric in its two runs."""
    topo = trace_topology(graph)
    names = sorted(prunable_bn_names(graph))
    rows = []
    for c in checkpoints:
        m_run = masks_for(run[c], graph, topo)
        rows.append({
            "steps": c,
            "pearson_ref": within_layer_corr(run[c], ref[c], names),
            "pearson_floor": within_layer_corr(run[c], floor[c], names),
            "spearman_ref": within_layer_corr(run[c], ref[c], names,
                                              rank=True),
            "spearman_floor": within_layer_corr(run[c], floor[c], names,
                                                rank=True),
            "layer_mean_corr": layer_mean_corr(run[c], ref[c], names),
            "mask_agree_ref": mask_agreement(
                m_run, masks_for(ref[c], graph, topo)),
            "mask_agree_floor": mask_agreement(
                m_run, masks_for(floor[c], graph, topo)),
        })
    return rows


def check_row(row: dict) -> None:
    """One checkpoint's gates: against the reference, the within-layer
    statistics within 0.10 of the floor's and the masks within 0.04; the
    layers' mean scores correlated above 0.95."""
    assert row["pearson_ref"] > row["pearson_floor"] - 0.10, row
    assert row["spearman_ref"] > row["spearman_floor"] - 0.10, row
    assert row["mask_agree_ref"] > row["mask_agree_floor"] - 0.04, row
    assert row["layer_mean_corr"] > 0.95, row


def pearson_gap(row: dict) -> float:
    return row["pearson_floor"] - row["pearson_ref"]


def check_rows(rows: Sequence[dict]) -> None:
    """The gates of ``tests/test_eic_horizon.py``: ``check_row`` at every
    checkpoint, and the Pearson gap to the floor at the last checkpoint
    at most 0.02 above the first's (the gap shrinks with the horizon)."""
    assert rows, "no rows"
    for row in rows:
        check_row(row)
    first, last = pearson_gap(rows[0]), pearson_gap(rows[-1])
    assert last <= first + 0.02, (first, last, rows[-1])


# -- the card -----------------------------------------------------------------

RUNS = ("f32", "f32_floor", "tf32")


def card_horizon(steps: int = 200, hw: int = 257, batch: int = 2,
                 checkpoints: Optional[Sequence[int]] = None, *,
                 device: DeviceLike = None) -> dict:
    """The flagship (``build_horizon_model(128)``, init from seed 0)
    pretrained three times on ``steps`` batches of ``batch`` x ``hw``^2
    crops of the stream: f32, f32 from ``perturb(params)`` and
    TF32.  ``rows``: ``horizon_rows(tf32, f32, f32_floor)``, which
    ``check_card`` gates; ``rows_f32_own_floor``: ``horizon_rows(f32,
    tf32, f32_floor)``, TF32 against f32 next to f32's own floor,
    measured only.  Also each run's median step ms, its first and last
    10 losses, and the card."""
    dev = resolve_device(device)
    cps = list(checkpoints or checkpoints_for(steps))
    model = build_horizon_model(128)
    params, bn = init_graph(model.graph, torch.Generator().manual_seed(0),
                            device="cpu")
    batches = make_pretrain_batches(steps, hw=hw, batch=batch)
    runs = {}
    for name in RUNS:
        runs[name] = run_with_snapshots(
            model, perturb(params) if name == "f32_floor" else params, bn,
            batches, steps, cps, device=dev, tf32=name == "tf32")
    eic = {name: r.eic for name, r in runs.items()}
    rows = horizon_rows(eic["tf32"], eic["f32"], eic["f32_floor"],
                        model.graph, cps)
    own = horizon_rows(eic["f32"], eic["tf32"], eic["f32_floor"],
                       model.graph, cps)
    return {
        "device": card_name_and_power() if dev.type == "cuda" else "cpu",
        "model": "deeplabv3-r50 os8 mg[1,2,4] inplanes 128 deepsup",
        "batch": [batch, hw, hw], "steps": steps, "checkpoints": cps,
        "n_layers": len(prunable_bn_names(model.graph)), "rows": rows,
        "rows_f32_own_floor": own,
        "runs": {name: {"median_step_ms": r.median_step_ms,
                        "first_losses": r.losses[:10],
                        "last_losses": r.losses[-10:]}
                 for name, r in runs.items()}}


def check_losses_fall(result: dict) -> None:
    """Every run's loss falls: the mean of its last 10 steps below the
    mean of its first 10."""
    for name, r in result["runs"].items():
        first, last = np.mean(r["first_losses"]), np.mean(r["last_losses"])
        assert last < first, (name, first, last)


def check_card(result: dict) -> None:
    """``check_rows`` on the result's rows, and ``check_losses_fall``."""
    check_rows(result["rows"])
    check_losses_fall(result)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--hw", type=int, default=257)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    result = card_horizon(args.steps, args.hw, args.batch)
    result["seconds"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    for row in result["rows"] + result["rows_f32_own_floor"]:
        print(json.dumps(row), flush=True)
    print(json.dumps({k: v for k, v in result.items()
                      if not k.startswith("rows")}), flush=True)
    check_card(result)


if __name__ == "__main__":
    main()
