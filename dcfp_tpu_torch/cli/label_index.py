"""Offline label-index CLI (port of ``dcfp_tpu/cli/label_index.py``):
scans the train split and pickles the per-class file index consumed by
``--resample``.  Host work only; the file equals the JAX package's.

Example:
  python -m dcfp_tpu_torch.cli.label_index --dataset CS --save-dir datasets/list/cityscapes
"""

from __future__ import annotations

import argparse
import os


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dcfp_tpu_torch label_index")
    p.add_argument("--dataset", type=str, default="CS",
                   help="CS|CTX|ADE|COCO")
    p.add_argument("--data-dir", type=str, default="train")
    p.add_argument("--save-dir", type=str, required=True)
    return p


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    from dcfp_tpu_torch.data import paths
    from dcfp_tpu_torch.data.datasets import build_dataset
    from dcfp_tpu_torch.data.label_index import build_label_index

    root, list_path = paths.data_dir(args.dataset, args.data_dir)
    dataset = build_dataset(args.dataset, root, list_path,
                            split=args.data_dir)
    save_path = os.path.join(
        args.save_dir, f"label_index_{paths.dataset_key(args.dataset)}.pkl")
    build_label_index(dataset, save_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
