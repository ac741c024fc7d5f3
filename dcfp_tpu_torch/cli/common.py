"""Shared CLI plumbing (port of ``dcfp_tpu/cli/common.py``): the flag
groups, with the JAX package's option strings, defaults and choices;
JSON-para parsing; model/dataset construction; logging setup.  Dispatch
goes through explicit registries — no ``eval()``.

One process drives one card: the mesh and multi-process flags are
accepted, as the scripts pass them, and any value that asks for more
than one device raises ``NotImplementedError`` before a file is
written.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from dcfp_tpu_torch.data import paths
from dcfp_tpu_torch.data.datasets import build_dataset
from dcfp_tpu_torch.models.registry import build_model
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()

NOT_PORTED = "not ported yet (ROADMAP.md queue 1, item 5: distributed)"


def str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "1"):
        return True
    if v.lower() in ("no", "false", "f", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def json_para(v: str) -> Dict[str, Any]:
    return json.loads(v) if v else {}


def parse_hw(v: str) -> Tuple[int, int]:
    h, w = map(int, v.split(","))
    return h, w


# ---------------------------------------------------------------------------
# flag groups
# ---------------------------------------------------------------------------

def add_model_args(p: argparse.ArgumentParser, default_model="deeplabv3",
                   default_backbone="resnet50"):
    p.add_argument("--model", type=str, default=default_model,
                   help="seg head: deeplabv3|deeplabv3p|psp|simple")
    p.add_argument("--backbone", type=str, default=default_backbone,
                   help="resnet50|resnet101|resnet152|hrnetv2w48")
    p.add_argument("--backbone-para", type=json_para, default={},
                   help='JSON, e.g. \'{"os":8,"mg_unit":[1,2,4]}\'')
    p.add_argument("--model-para", type=json_para, default={})
    p.add_argument("--align-corner", type=str2bool, default=True)
    p.add_argument("--channel-cfg", type=str, default=None,
                   help="path to channel_cfg.msgpack (pruned widths); "
                        "also accepts a reference channel_cfg.pth")


def add_data_args(p: argparse.ArgumentParser, split="train"):
    p.add_argument("--dataset", type=str, default="CS",
                   help="CS|CTX|ADE|COCO")
    p.add_argument("--data-dir", type=str, default=split,
                   help="dataset split (train/val/test)")
    p.add_argument("--ignore-label", type=int, default=255)
    p.add_argument("--input-size", type=str, default="769,769",
                   help="crop H,W")
    p.add_argument("--longsize", type=int, default=-1)
    p.add_argument("--shortsize", type=int, default=-1)
    p.add_argument("--data-para", type=json_para, default={})
    p.add_argument("--num-workers", type=int,
                   default=4 if split == "train" else 8,
                   help="decode worker processes when >1 (reference "
                        "DataLoader workers + defaults, engine.py:81-115, "
                        "train.py:64, evaluate.py:46); otherwise one "
                        "prefetch thread; single-core hosts auto-fall "
                        "back to the thread")


def add_train_data_args(p: argparse.ArgumentParser):
    p.add_argument("--random-mirror", action="store_true")
    p.add_argument("--random-brightness", action="store_true")
    p.add_argument("--random-scale", action="store_true")
    p.add_argument("--balance", type=int, default=0,
                   help="0 none | 1 inverse-freq | 2 effective-number")
    p.add_argument("--batch-size", type=int, default=8,
                   help="GLOBAL batch (one card here)")


def add_optim_args(p: argparse.ArgumentParser):
    p.add_argument("--optim", type=str, default="sgd", help="sgd|adamw")
    p.add_argument("--learning-rate", type=float, default=1e-2)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--power", type=float, default=0.9)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--betas", type=str, default="0.9,0.999")
    p.add_argument("--warmup", type=int, default=-1)
    p.add_argument("--no-decay", type=str, default=None,
                   help="comma-joined param-name keywords w/o weight decay")


def add_runtime_args(p: argparse.ArgumentParser):
    p.add_argument("--random-seed", type=int, default=304)
    p.add_argument("--snapshot-dir", type=str, default="snapshots")
    p.add_argument("--save-log", action="store_true")
    p.add_argument("--spatial-shards", type=int, default=1,
                   help="mesh 'spatial' axis size (H sharding); only 1 "
                        "here")
    p.add_argument("--num-devices", type=int, default=-1,
                   help="limit the mesh to the first N devices; -1 or 1 "
                        "here (one card)")
    p.add_argument("--dcn-slices", type=int, default=0,
                   help="multi-slice pods: number of slices; 0 or 1 here")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   help="float32|bfloat16 activations")
    add_distributed_args(p)


def add_distributed_args(p: argparse.ArgumentParser):
    """Multi-process runtime flags (the reference's torch.distributed
    launch, engine.py:38-46); accepted, and ``--distributed true``
    raises: the port runs one process."""
    p.add_argument("--distributed", type=str2bool, default=False,
                   help="multi-process job (not ported: raises)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="coordinator address host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def maybe_initialize_distributed(args) -> None:
    """No-op unless ``--distributed true``, which raises
    NotImplementedError: multi-process runs are not ported."""
    if getattr(args, "distributed", False):
        raise NotImplementedError(f"--distributed true is {NOT_PORTED}")


def require_one_card(args) -> None:
    """Raise NotImplementedError for mesh flags that ask for more than
    the one card this port drives (before any file is written)."""
    if getattr(args, "num_devices", -1) not in (-1, 1):
        raise NotImplementedError(
            f"--num-devices {args.num_devices}: a device mesh is "
            f"{NOT_PORTED}; use -1 or 1")
    if getattr(args, "spatial_shards", 1) > 1:
        raise NotImplementedError(
            f"--spatial-shards {args.spatial_shards}: spatial sharding is "
            f"{NOT_PORTED}")
    if getattr(args, "dcn_slices", 0) > 1:
        raise NotImplementedError(
            f"--dcn-slices {args.dcn_slices}: multi-slice meshes are "
            f"{NOT_PORTED}")


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------

def build_dataset_from_args(args, split: Optional[str] = None, **extra):
    split = split or args.data_dir
    root, list_path = paths.data_dir(args.dataset, split)
    crop = parse_hw(args.input_size)
    kw: Dict[str, Any] = dict(
        split=split, crop_size=crop, ignore_label=args.ignore_label,
        longsize=args.longsize, shortsize=args.shortsize,
        seed=getattr(args, "random_seed", 0))
    if split == "train":
        kw.update(scale=getattr(args, "random_scale", False),
                  mirror=getattr(args, "random_mirror", False),
                  brightness=getattr(args, "random_brightness", False),
                  balance=getattr(args, "balance", 0))
    kw.update(args.data_para)
    kw.update(extra)
    return build_dataset(args.dataset, root, list_path, **kw)


def build_model_from_args(args, num_classes: int, deepsup: bool):
    return build_model(args.model, backbone=args.backbone,
                       backbone_para=args.backbone_para,
                       model_para=args.model_para,
                       num_classes=num_classes,
                       align_corner=args.align_corner, deepsup=deepsup)


def maybe_load_channel_cfg(args):
    if getattr(args, "channel_cfg", None):
        from dcfp_tpu_torch.utils.checkpoint import load_channel_cfg
        cfg = load_channel_cfg(args.channel_cfg)
        log.info("loaded channel_cfg from %s (%d layers)",
                 args.channel_cfg, len(cfg))
        return cfg
    return None


def setup_dirs_and_logging(args) -> None:
    os.makedirs(args.snapshot_dir, exist_ok=True)
    if getattr(args, "save_log", False):
        get_logger(log_file=os.path.join(args.snapshot_dir, "train.log"))


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "bf16": torch.bfloat16}


def compute_dtype(args) -> torch.dtype:
    return DTYPES[args.compute_dtype]


def init_params(graph, seed: int = 0):
    """Params of ``graph`` from ``seed``, on the CPU (the JAX CLIs'
    ``init_graph(graph, jax.random.key(seed))``): the template that a
    snapshot is loaded into, moved to the card by the loader."""
    from dcfp_tpu_torch.graph.apply import init_graph
    return init_graph(graph, torch.Generator().manual_seed(seed),
                      device="cpu")
