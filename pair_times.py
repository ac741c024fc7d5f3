"""Time the port's K1-K6 in two checkouts of the repo, in turns, on one
CUDA card: A, B, B, A.

    python3 pair_times.py PARENT_DIR CHANGE_DIR [--out FILE]

Each turn is a fresh process in that checkout, which builds its kernels
and times them with its own ``chip_smoke.py`` helpers (``time_k5`` at
1024^3 and 64x4096x1024 in int8 and bf16; ``time_k3`` at the pruned
R101's layer3 and layer4 shapes) and its own launch entries (K1 at the
deploy shape, 1 x 19 x 129 x 257 bf16 -> 1025 x 2049, channels_last and
NCHW, in a CUDA graph; K4 at the ASPP probe's stage B, 129 x 257 x 2048
-> 3 x 128 on seeded data; K6 at the int8 probe's stage-B shape and the
pruned layer3's, on ``chip_smoke.py``'s inputs; CUDA events over 30
launches after 5, on weights prepared once; K2 at the deploy shape,
1 x 12 x 536 x 1026 bf16 -> 64 x 513 x 1025 channels_last, on weights
prepared once, in a CUDA graph), so both sides use the same inputs,
timers and yardsticks.  Each turn also prints the sha256 of K1's labels
on every case of this checkout's ``chip_smoke.K1_CASES`` and ``K1_ODD``
(f32 and bf16, NCHW and channels_last), and of K2's bf16 output (ReLU
off and on) on every case of its ``K2_CASES`` and ``K2_ODD``, from
inputs made on the card from a fixed seed, and the last lines say
whether A's and B's labels and K2 outputs are bit-equal.  Prints one
JSON line per turn and, last, the card's name and power limit; exits
non-zero without a card.  About 50 s a turn on an H100.
"""

import argparse
import json
import subprocess
import sys

TURN = r"""
import hashlib, json, sys, torch
import chip_smoke as cs
cs.phase_device()
cs.phase_build()
gen = torch.Generator(device="cuda").manual_seed(6)
out = {}
for m, k, n in ((1024, 1024, 1024), (64, 4096, 1024)):
    for dt in (torch.int8, torch.bfloat16):
        out[f"k5 {m}x{k}x{n} {str(dt)[6:]}"] = cs.time_k5(
            *cs._k5_inputs(m, k, n, dt, gen))
gen = torch.Generator(device="cuda").manual_seed(5)
for name, (n, h, w, cin, cm, d) in cs.K3_DEPLOY.items():
    x, args = cs._bottleneck_inputs(n, h, w, cin, cm, gen, torch.bfloat16,
                                    (0.5, 0.04, 0.08, 0.08, 0.1))
    x = x.contiguous(memory_format=torch.channels_last)
    out[f"k3 {name}"] = cs.time_k3(name, x, args, d)
from dcfp_tpu_torch.ops import aspp, int8
gen = torch.Generator(device="cuda").manual_seed(11)
x = (torch.randn((129, 257, 2048), device="cuda", generator=gen).relu()
     * 0.5).to(torch.bfloat16)
wt = aspp.aspp_kernel_weights((torch.randn(
    (27, 2048, 128), device="cuda", generator=gen) * 0.01).to(torch.bfloat16))
out["k4 stage B"] = cs.cuda_ms(lambda: aspp.aspp_fused_launch(x, wt), 30, 5)
for seed, (name, shape) in enumerate(cs.K6_SHAPES.items(), 1):
    x8, w1, w2, w3 = cs._k6_inputs(*shape, seed)
    cw = int8.chain_int8_weights(w1, w2, w3)
    out[f"k6 {name}"] = cs.cuda_ms(
        lambda: int8.chain_int8_launch(x8, cw, cs.K6_SCALES), 30, 5)
from dcfp_tpu_torch.ops import kernels
gen = torch.Generator(device="cuda").manual_seed(1)
z = torch.randn((1, 19, 129, 257), device="cuda", generator=gen).to(
    torch.bfloat16).contiguous(memory_format=torch.channels_last)
z_nchw = z.contiguous()
out["k1 deploy"] = cs.graph_ms(
    lambda: kernels.resize_argmax_cm(z, (1025, 2049), True))
out["k1 deploy nchw"] = cs.graph_ms(
    lambda: kernels.resize_argmax_cm(z_nchw, (1025, 2049), True))
gen = torch.Generator(device="cuda").manual_seed(7)
digests = {}
for shape, out_hw, ac in json.loads(sys.argv[1]):
    for dtype in (torch.float32, torch.bfloat16):
        z = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        h = hashlib.sha256()
        for zz in (z, z.contiguous(memory_format=torch.channels_last)):
            h.update(kernels.resize_argmax_cm(zz, tuple(out_hw), ac)
                     .cpu().numpy().tobytes())
        digests[f"{tuple(shape)}->{tuple(out_hw)} ac={ac} "
                f"{str(dtype)[6:]}"] = h.hexdigest()
gen = torch.Generator(device="cuda").manual_seed(3)
n, h, w, cin, cout = cs.K2_CASES[-1]
img, ph, k, b = cs._stem_inputs(n, h, w, cin, cout, gen)
ph = ph.to(torch.bfloat16)
km, bf = kernels.stem_weights(k.to(torch.bfloat16), b.to(torch.bfloat16),
                              ph.dtype, ph.device)
out_hw = ((h + 1) // 2, (w + 1) // 2)
out["k2 deploy"] = cs.graph_ms(
    lambda: kernels.stem_conv3x3_s2_prepared(ph, km, bf, out_hw))
del img, ph
from dcfp_tpu_torch.ops.stem import extract_stem_phases
gen = torch.Generator(device="cuda").manual_seed(8)
k2 = {}
for n, h, w, cin, cout, off in json.loads(sys.argv[2]):
    img = torch.randn((n, h, w, cin), device="cuda", generator=gen)
    k = torch.randn((cout, cin, 3, 3), device="cuda", generator=gen) * 0.1
    b = torch.randn(cout, device="cuda", generator=gen)
    ph = torch.stack([extract_stem_phases(img[i]) for i in range(n)]).to(
        torch.bfloat16)
    if off:  # data_ptr() off 4 bytes
        buf = torch.empty(ph.numel() + off, dtype=ph.dtype, device="cuda")
        ph = buf[off:].view(ph.shape).copy_(ph)
    h_ = hashlib.sha256()
    for relu in (False, True):
        y = kernels.stem_conv3x3_s2(ph, k, b, ((h + 1) // 2, (w + 1) // 2),
                                    relu=relu)
        h_.update(y.view(torch.int16).cpu().numpy().tobytes())
    k2[f"({n},{h},{w},{cin})->{cout} off={off}"] = h_.hexdigest()
print("PAIR " + json.dumps(out), flush=True)
print("K1LABELS " + json.dumps(digests), flush=True)
print("K2OUT " + json.dumps(k2), flush=True)
"""


def _agree(turns, what):
    """One JSON line: whether every turn's digests agree, case by case."""
    differ = sorted(k for k in turns[0]
                    if len({d.get(k) for d in turns}) > 1)
    print(json.dumps({f"{what}_bit_equal_a_b": not differ,
                      "cases": len(turns[0]), "differing": differ}),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--out", default=None,
                    help="also append every turn's full output here")
    opts = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise SystemExit("pair_times: no CUDA card (nvidia-smi failed)")
    from chip_smoke import K1_CASES, K1_ODD, K2_CASES, K2_ODD
    cases = json.dumps(K1_CASES + K1_ODD)
    k2_cases = json.dumps([c + (0,) for c in K2_CASES] + K2_ODD)
    log = open(opts.out, "a") if opts.out else None
    labels, k2 = [], []
    for turn, tree in enumerate((opts.a, opts.b, opts.b, opts.a)):
        proc = subprocess.run([sys.executable, "-c", TURN, cases, k2_cases],
                              cwd=tree, capture_output=True, text=True,
                              timeout=900)
        if log:
            log.write(f"==== turn {turn} {tree}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            raise SystemExit(f"pair_times: turn {turn} in {tree} failed:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        line = next(x for x in proc.stdout.splitlines()
                    if x.startswith("PAIR "))
        print(json.dumps({"turn": turn, "tree": tree,
                          "times": json.loads(line[5:])}), flush=True)
        lines = proc.stdout.splitlines()
        labels.append(json.loads(next(
            x for x in lines if x.startswith("K1LABELS "))[9:]))
        k2.append(json.loads(next(
            x for x in lines if x.startswith("K2OUT "))[6:]))
    for turn, (digests, outs) in enumerate(zip(labels, k2)):
        print(json.dumps({"turn": turn, "k1_label_sha256": digests,
                          "k2_output_sha256": outs}), flush=True)
    _agree(labels, "k1_labels")
    _agree(k2, "k2_outputs")
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
