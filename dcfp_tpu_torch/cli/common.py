"""Shared CLI plumbing (port of ``dcfp_tpu/cli/common.py``): the flag
groups, with the JAX package's option strings, defaults and choices;
JSON-para parsing; model/dataset construction; logging setup.  Dispatch
goes through explicit registries — no ``eval()``.

One process drives one card, and a job on W cards runs W processes (the
data axis of the JAX package's mesh is the process axis here,
``parallel/``).  A job reaches that state three ways: ``torchrun``
(its environment is read), ``--distributed true`` with ``--coordinator
host:port --num-processes N --process-id i`` per process, or the scripts'
unchanged commands, for which the CLI starts one worker process per card
itself (``launch_workers``).  ``--spatial-shards S`` splits those W
processes into a ``(W / S) x S`` mesh: each group of S consecutive
ranks takes the same images and holds bands of their rows
(``parallel/spatial.py``); a count that does not divide raises before a
file is written or a process started (``mesh_axes``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import socket
import sys
from typing import Any, Dict, Optional, Tuple

import torch

from dcfp_tpu_torch.data import paths
from dcfp_tpu_torch.data.datasets import build_dataset
from dcfp_tpu_torch.models.registry import build_model
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()

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
                   help="GLOBAL batch, split evenly over the processes")


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
                   help="mesh 'spatial' axis size: image height split "
                        "over this many processes of each data group")
    p.add_argument("--num-devices", type=int, default=-1,
                   help="cards of the job, one process each; -1 = every "
                        "visible card (on the CPU: N gloo processes, "
                        "-1 = one)")
    p.add_argument("--dcn-slices", type=int, default=0,
                   help="multi-node jobs: number of nodes; validates that "
                        "the processes divide into them")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   help="float32|bfloat16 activations")
    add_distributed_args(p)


def add_distributed_args(p: argparse.ArgumentParser):
    """Multi-process runtime flags (the reference's torch.distributed
    launch, engine.py:38-46)."""
    p.add_argument("--distributed", type=str2bool, default=False,
                   help="join a multi-process job (one process per card)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="coordinator address host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def maybe_initialize_distributed(args, device: torch.device) -> None:
    """Join the job's process group under ``--distributed true`` or
    ``torchrun`` (no-op otherwise, and for a job of one process)."""
    from dcfp_tpu_torch.parallel import distributed
    if getattr(args, "distributed", False) \
            or distributed.launched_by_torchrun():
        distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.num_processes,
                               process_id=args.process_id, device=device)


def mesh_axes(args, world: int) -> Tuple[int, int]:
    """(n_data, n_spatial) of a job of ``world`` processes under
    ``--spatial-shards``; raises ValueError when it does not divide."""
    s = getattr(args, "spatial_shards", 1)
    if s < 1 or world % s:
        raise ValueError(f"--spatial-shards {s} does not divide the job's "
                         f"{world} process(es)")
    return world // s, s


def job_world(args, device: torch.device, cards: Optional[int]
              ) -> Tuple[int, bool]:
    """(W, start): the processes of this job, and whether this process
    must start them (``launch_workers``).  Under a launcher (a process
    group, ``torchrun``, ``--distributed true``) W is the group's and
    nothing is started.  Otherwise W is ``cards`` (<= 0: every visible
    card, one on the CPU; None: one).  A job asked for more cards than
    are visible, or for another count than its launcher started, raises
    rather than run on fewer."""
    from dcfp_tpu_torch.parallel import distributed, mesh
    launched = (mesh.world() > 1 or getattr(args, "distributed", False)
                or distributed.launched_by_torchrun())
    if launched:
        w = mesh.world()
        if cards is not None and 0 < cards != w:
            raise ValueError(f"--num-devices {cards} but the job has {w} "
                             "processes")
        return w, False
    if cards is None:
        return 1, False
    visible = torch.cuda.device_count() if device.type == "cuda" else None
    w = cards if cards > 0 else (visible or 1)
    if visible is not None and w > visible:
        raise ValueError(f"--num-devices {w}: only {visible} CUDA card(s) "
                         "are visible")
    return w, w > 1


def make_mesh(args, device: torch.device):
    """This rank's mesh over every process of the job: the pod mesh's
    validation of ``--dcn-slices``, then the data axis over the ranks."""
    from dcfp_tpu_torch.parallel.distributed import create_pod_mesh
    return create_pod_mesh(n_spatial=getattr(args, "spatial_shards", 1),
                           dcn_data_parallel=getattr(args, "dcn_slices", 0),
                           device=device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(local_rank: int, module: str, argv, world: int,
            port: int) -> None:
    """One worker of ``launch_workers``: torchrun's environment for
    ``local_rank``, then the CLI's ``main(argv)``, which joins the
    group from it."""
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    rc = importlib.import_module(module).main(argv)
    if rc:
        raise SystemExit(rc)


def launch_workers(module: str, argv, world: int) -> int:
    """Run ``module``'s ``main(argv)`` in ``world`` processes on this
    host, one per card (rank i on ``cuda:i``; on the CPU, gloo), started
    with the spawn method over a free localhost port: the scripts'
    unchanged commands use every card, as the JAX package's do.  Each
    collective waits at most ``parallel.distributed.DEFAULT_TIMEOUT``;
    a worker that fails makes the others stop and this call raise."""
    import torch.multiprocessing as mp
    argv = sys.argv[1:] if argv is None else list(argv)
    port = _free_port()
    log.info("starting %d worker processes (localhost:%d)", world, port)
    mp.start_processes(_worker, args=(module, argv, world, port),
                       nprocs=world, join=True, start_method="spawn")
    return 0


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
    """The snapshot directory, and ``train.log`` in it under
    ``--save-log``, written by rank 0 only."""
    from dcfp_tpu_torch.parallel.mesh import rank
    os.makedirs(args.snapshot_dir, exist_ok=True)
    if getattr(args, "save_log", False) and rank() == 0:
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
