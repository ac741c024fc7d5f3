"""Offline FLOPs-targeted pruning entry point (port of
``dcfp_tpu/cli/prune.py``).

Loads the pretrained checkpoint + EIC scores, sweeps ``global_percent``
until the deploy-graph FLOPs ratio hits 1 - prune_ratio
(reference prune.py:91-124), then writes:

* ``<save-path>/pruned.msgpack``      — physically sliced params+BN state
* ``<save-path>/channel_cfg.msgpack`` — pruned-width config for rebuilds

and round-trips the artifacts (rebuild from channel_cfg, reload pruned
weights, verify the forward on the card matches the surgically-pruned
model) — the reference's implicit self-check (prune.py:100-113) made an
explicit gate.  The files equal the JAX package's for the same inputs.
``--trace jaxpr`` prunes with the topology of the traced forward
(``prune/fx_trace.py``), ``--trace verify`` checks it against the IR's
before pruning with the latter.

Example (scripts/cs/prune.sh with the module renamed):
  python -m dcfp_tpu_torch.cli.prune --model deeplabv3 --backbone resnet50 \\
      --backbone-para '{"os":8,"mg_unit":[1,2,4]}' --dataset CS \\
      --model-path snapshots/cs_pretrain/CS_scenes_4000.msgpack \\
      --score-path snapshots/cs_pretrain/score.msgpack \\
      --prune-ratio 0.6 --save-path snapshots/cs_prune
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dcfp_tpu_torch.cli import platform_device
from dcfp_tpu_torch.cli.common import add_model_args, init_params, str2bool
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()

NUM_CLASSES = {"CS": 19, "CTX": 59, "ADE": 150, "COCO": 171}


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dcfp_tpu_torch prune")
    add_model_args(p)
    p.add_argument("--dataset", type=str, default="CS")
    p.add_argument("--save-path", type=str, default="./ckpt")
    p.add_argument("--model-path", type=str, required=True,
                   help="pretrained snapshot (.msgpack, or a reference "
                        "torch .pth)")
    p.add_argument("--score-path", type=str, required=True,
                   help="EIC scores (score.msgpack, or a reference "
                        "score.pth)")
    p.add_argument("--prune-ratio", type=float, default=0.6,
                   help="FLOPs reduction target")
    p.add_argument("--start_global_percent", type=float, default=0.5)
    p.add_argument("--step_global_percent", type=float, default=0.02)
    p.add_argument("--layer-keep", type=float, default=0.02)
    p.add_argument("--channel-align", type=int, default=128,
                   help="round kept channels per space UP to this multiple "
                        "(1 = reference behavior)")
    p.add_argument("--flops-input-size", type=str, default="512,512")
    p.add_argument("--trace", type=str, default="ir",
                   choices=("ir", "jaxpr", "verify"),
                   help="channel-topology derivation: declared layer "
                        "graph (ir), the aten graph of the traced forward "
                        "(jaxpr, the JAX package's name for it; the analog "
                        "of the reference's autograd walk, "
                        "channel_pruner.py:501-737), or both with an "
                        "exact-agreement gate (verify)")
    p.add_argument("--export-torch", type=str2bool, default=False,
                   help="also write pruned.pth + channel_cfg.pth in the "
                        "reference's torch formats, consumable by its "
                        "init_pruned_model/load_model "
                        "(channel_pruner.py:29-74)")
    p.add_argument("--verify-forward", type=str2bool, default=True,
                   help="round-trip equivalence check after surgery")
    return p


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    device = platform_device()
    from dcfp_tpu_torch.bridge import params_from_numpy, params_to_numpy
    from dcfp_tpu_torch.cli.common import build_model_from_args
    from dcfp_tpu_torch.data.paths import dataset_key
    from dcfp_tpu_torch.graph.apply import graph_apply
    from dcfp_tpu_torch.prune.pruner import apply_channel_cfg
    from dcfp_tpu_torch.prune.search import prune_to_flops
    from dcfp_tpu_torch.utils import checkpoint as ckpt

    num_classes = NUM_CLASSES[dataset_key(args.dataset)]
    # deepsup=True graph is what was trained (pruned with conv_deepsup
    # excluded); deepsup=False graph is the deploy/FLOPs-accounting one
    # (reference prune.py:70-96).
    train_model = build_model_from_args(args, num_classes, deepsup=True)
    deploy_model = build_model_from_args(args, num_classes, deepsup=False)

    params, bn_state = init_params(train_model.graph)
    params, bn_state = ckpt.load_params_non_strict(
        args.model_path, params, bn_state, device="cpu")
    eic = ckpt.load_eic(args.score_path)

    hw = tuple(int(x) for x in args.flops_input_size.split(","))
    np_params, np_state = params_to_numpy(params, bn_state)
    result, gp, report = prune_to_flops(
        train_model.graph, deploy_model.graph, np_params, np_state, eic,
        prune_ratio=args.prune_ratio, layer_keep=args.layer_keep,
        except_start_keys=("conv_deepsup",), input_hw=hw,
        start_percent=args.start_global_percent,
        step=args.step_global_percent, channel_align=args.channel_align,
        trace=args.trace)

    os.makedirs(args.save_path, exist_ok=True)
    pruned_path = os.path.join(args.save_path, "pruned.msgpack")
    cfg_path = os.path.join(args.save_path, "channel_cfg.msgpack")
    ckpt.save_pruned(pruned_path, result.params, result.state)
    ckpt.save_channel_cfg(cfg_path, result.channel_cfg)
    if args.export_torch:
        ckpt.save_pruned(os.path.join(args.save_path, "pruned.pth"),
                         result.params, result.state)
        ckpt.save_channel_cfg(
            os.path.join(args.save_path, "channel_cfg.pth"),
            result.channel_cfg)
    log.info("global_percent=%.2f flops_ratio=%.3f -> %s, %s", gp,
             report["flops_ratio"], pruned_path, cfg_path)

    if args.verify_forward:
        # rebuild-from-cfg + reload must match the surgical model
        # (the reference's prune.py:100-113 round-trip, made exact).
        rebuilt = apply_channel_cfg(
            build_model_from_args(args, num_classes, deepsup=True).graph,
            ckpt.load_channel_cfg(cfg_path))
        p1, s1 = params_from_numpy(result.params, result.state, device)
        p2, s2 = ckpt.load_pruned(pruned_path, device=device)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (1, 65, 65, 3)).astype(np.float32)).to(device)
        with torch.inference_mode():
            out1, _ = graph_apply(result.graph, p1, s1, {"image": x})
            out2, _ = graph_apply(rebuilt, p2, s2, {"image": x})
        np.testing.assert_allclose(out1["pred"].cpu().numpy(),
                                   out2["pred"].cpu().numpy(), rtol=1e-5,
                                   atol=1e-5)
        log.info("round-trip forward equivalence verified")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
