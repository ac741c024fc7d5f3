"""Where K3's time goes: its bf16 kernel with parts switched off, on one
CUDA card.

    python3 k3_parts.py

Builds variants of ``dcfp_tpu_torch/csrc/bottleneck.cu`` into
``.chip_tree/k3_parts/`` (git-ignored), each with one part of the wgmma
path removed by a source edit, and times every variant with CUDA events
(30 launches after 5) at the pruned R101's layer3 and layer4 shapes, on
``chip_smoke.py``'s probe inputs and the wrapper's own tile.  A variant's
output is wrong by design; only its time means something: the time a
part costs is at most base minus the variant without it.  Prints one
line per shape and variant, then the card's name and power limit; exits
non-zero without a card or when a part's hook is no longer in the
source.
"""

import ctypes
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from dcfp_tpu_torch.ops import bottleneck as B
from dcfp_tpu_torch.ops import cuda_build as cb
from dcfp_tpu_torch.ops.kernels import _CI, _CL, _VP

SRC = cb.CSRC_DIR / "bottleneck.cu"
OUT = Path(__file__).resolve().parent / ".chip_tree" / "k3_parts"

# variant: [(text in the source, its replacement)]
PARTS = {
    "base": [],
    # conv3's epilogue: residual copy, add and store
    "no_conv3_epilogue": [(
        "    if (on && runs) {\n      for (int e = tid; e < G.Pp * 8;",
        "    if (false) {\n      for (int e = tid; e < G.Pp * 8;"), (
        "    drain();\n    if (!on) continue;\n    if (runs) {",
        "    drain();\n    if (acc[0][0] == 1.5e30f) out[0] = out[1];\n"
        "    continue;\n    if (runs) {")],
    # only the store of y (the residual is still copied and added)
    "no_y_store": [(
        "          *reinterpret_cast<uint4*>(out + off + col0 + c * 8) =",
        "          if (off == -7) *reinterpret_cast<uint4*>(out) =")],
    "no_conv1_wgmma": [(
        "    const int col0 = p1 * kNc + wg * 64;\n"
        "    const bool on = col0 < G.cmp;",
        "    const int col0 = p1 * kNc + wg * 64;\n    const bool on = false;")],
    "no_3x3_wgmma": [(
        "    const int col0 = p2 * kNc + wg * 64;\n"
        "    const bool on = col0 < G.cmp;",
        "    const int col0 = p2 * kNc + wg * 64;\n    const bool on = false;")],
    "no_conv3": [(
        "    const int col0 = p3 * kNc + wg * 64;\n"
        "    const bool on = col0 < G.cinp;",
        "    const int col0 = p3 * kNc + wg * 64;\n    const bool on = false;")],
    "no_x_staging": [(
        "        if (runs) {\n          for (int e = tid; e < G.Qp * 8;",
        "        if (false) {\n          for (int e = tid; e < G.Qp * 8;"), (
        "          for (int e = tid; e < G.Qp * kKs; e += 128) {",
        "          for (int e = tid; e < 0; e += 128) {")],
}


def build():
    src = SRC.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in PARTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"k3_parts: the hook of {name} is not in "
                                 f"{SRC}: {old[:60]!r}")
            text = text.replace(old, new)
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [cb._nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC_DIR), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k3_parts: nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so.resolve())).dcfp_fused_bottleneck
        fn.argtypes = [_VP, _CI, _CI, _CI, _CI, _CI, _CL, _CL, _CL, _CL,
                       _CI, _CI, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _CI,
                       _CI, _CI, _VP]
        fns[name] = fn
    return fns


def main():
    cs.phase_device()
    fns = build()
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape, (n, h, w, cin, cm, d) in cs.K3_DEPLOY.items():
        x, args = cs._bottleneck_inputs(n, h, w, cin, cm, gen,
                                        torch.bfloat16,
                                        (0.5, 0.04, 0.08, 0.08, 0.1))
        x = x.contiguous(memory_format=torch.channels_last)
        wk = B.bottleneck_weights(*args, x.dtype, x.device)
        tile = B._tile(h, w, d, cin, cm, 2)
        out = torch.empty_like(x)
        for name, fn in fns.items():
            def run(fn=fn):
                err = fn(x.data_ptr(), 1, n, cin, h, w, *x.stride(), cm, d,
                         *(t.data_ptr() for t in wk), out.data_ptr(), *tile,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            ms = cs.cuda_ms(run, 30, 5)
            print(f"[k3_parts] {shape} tile {list(tile)} {name}: {ms:.4f} ms",
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
