"""The cells at sizes a CPU test run can hold: the same configurations
(every width as published, the pruned widths as configured), smaller
frames, crops and batches."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import run as bench  # noqa: E402

SERVE, TRAIN = "serve.r101p50.b1", "train.r50p60.b8"


def spec(cell):
    s = bench.cell_spec(bench.load_json("BENCHMARK.json"), cell)
    if cell == SERVE:
        s["traffic"] = dict(s["traffic"], frame_hw=[65, 129], pool_frames=3,
                            sample_share=1.0, sample_max=2,
                            max_requests=3, warmup_requests=1)
    else:
        s["traffic"] = dict(s["traffic"], crop_hw=[65, 65], global_batch=4,
                            pool_batches=3, label_block=8, chunk_steps=1)
    return s
