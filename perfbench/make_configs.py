"""Write the pruned widths of the benchmark's two configurations.

    python3 perfbench/make_configs.py

Runs the port's own prune search (``prune.search.prune_to_flops``) on the
CPU once, with ``bench.py``'s synthetic EIC rule (``default_rng(0)``
scores, ``channel_align=128``), and stores each result's ``channel_cfg``
in ``perfbench/configs/<name>.json`` beside the model's description, so
that no benchmark run searches.  The benchmark itself never runs this
file; it is kept to show where the widths came from and to rebuild them.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def search(backbone, deepsup_train, prune_ratio, except_keys):
    import torch
    from dcfp_tpu_torch.bridge import params_to_numpy
    from dcfp_tpu_torch.graph.apply import init_graph
    from dcfp_tpu_torch.models.registry import build_model
    from dcfp_tpu_torch.prune.eic import prunable_bn_names
    from dcfp_tpu_torch.prune.search import prune_to_flops
    kw = dict(backbone=backbone,
              backbone_para={"os": 8, "mg_unit": [1, 2, 4], "inplanes": 128},
              num_classes=19, align_corner=True)
    train = build_model("deeplabv3", deepsup=deepsup_train, **kw).graph
    deploy = build_model("deeplabv3", deepsup=False, **kw).graph
    params, state = init_graph(train, torch.Generator().manual_seed(0),
                               device="cpu")
    rng = np.random.default_rng(0)
    eic = {bn: np.abs(rng.standard_normal(
        train.node(bn).attrs["channels"])).astype(np.float32)
        for bn in prunable_bn_names(train)}
    np_params, np_state = params_to_numpy(params, state)
    result, gp, report = prune_to_flops(
        train, deploy, np_params, np_state, eic, prune_ratio=prune_ratio,
        layer_keep=0.02, except_start_keys=except_keys, channel_align=128)
    cfg = {name: {k: int(c[k]) for k in ("in_channels", "out_channels")
                  if k in c}
           for name, c in sorted(result.channel_cfg.items())}
    return cfg, float(gp), float(report["flops_ratio"])


def main():
    sys.path.insert(0, os.path.dirname(HERE))
    for name, backbone, deepsup, ratio, keys in (
            ("deeplabv3_r101_p50", "resnet101", False, 0.5, ()),
            ("deeplabv3_r50_p60", "resnet50", True, 0.6,
             ("conv_deepsup",))):
        path = os.path.join(HERE, "configs", f"{name}.json")
        with open(path) as f:
            doc = json.load(f)
        cfg, gp, ratio_got = search(backbone, deepsup, ratio, keys)
        doc["prune_search"] = {"global_percent": gp,
                               "flops_ratio": round(ratio_got, 4)}
        doc["channel_cfg"] = cfg
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(name, gp, ratio_got, len(cfg))


if __name__ == "__main__":
    main()
