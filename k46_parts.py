"""Where K6's and K4's time goes: their kernels with parts switched off,
on other tiles than the planners', or against other copies of their
sources, on one CUDA card.

    python3 k46_parts.py                  # parts and tiles
    python3 k46_parts.py --against DIR    # DIR's sources (A) vs the tree's (B)

Builds variants of ``dcfp_tpu_torch/csrc/int8_chain.cu`` (K6) and
``dcfp_tpu_torch/csrc/aspp.cu`` (K4) into ``.chip_tree/k46_parts/``
(git-ignored), each with one part removed by a source edit, and times
every variant with CUDA events (30 launches after 5, through the C
entries): K6 at the int8 probe's stage-B shape and the pruned R101's
layer3 (``chip_smoke.py``'s inputs), K4 at the ASPP probe's stage B
(129 x 257 x 2048 -> 3 x 128, seeded like the served layer4 output).  The
base kernels are also timed on tiles other than the planners'.  A
variant's output is wrong by design; only its time means something: the
time a part costs is at most base minus the variant without it.

With ``--against DIR``, DIR holds other copies of ``int8_chain.cu``,
``aspp.cu`` and their headers (an older version of the kernels, with the
same C entries); each is timed against the tree's in turns, A, B, B, A,
at the same shapes and tiles.

Prints one line per shape and variant (or turn), then the card's name
and power limit; exits non-zero without a card or when a part's hook is
no longer in the source.  About 40 s on an H100, builds included.
"""

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from dcfp_tpu_torch.ops import aspp, int8
from dcfp_tpu_torch.ops import cuda_build as cb
from dcfp_tpu_torch.ops.kernels import _CF, _CI, _VP

OUT = Path(__file__).resolve().parent / ".chip_tree" / "k46_parts"

# source: (C entry, argtypes, {variant: [(text, replacement)]})
KERNELS = {
    "int8_chain": ("dcfp_chain_int8",
                   [_VP, _VP, _VP, _VP, _CF, _CF, _CF, _VP] + [_CI] * 9
                   + [_VP], {
        "base": [],
        "no_conv1_wgmma": [("wgmma_s8_ss(acc[mt],",
                            "if (nq < 0) wgmma_s8_ss(acc[mt],")],
        "no_x_staging": [("for (int e = tid; e < G.Qp * 8; e += 128) {",
                          "for (int e = tid; e < 0; e += 128) {")],
        "no_3x3_wgmma": [("wgmma_s8_rs_n128(acc, a[ks],",
                          "if (nq < 0) wgmma_s8_rs_n128(acc, a[ks],")],
        # the accumulators read, without the requant's float math (a
        # variant that leaves accumulators unread is no measurement:
        # ptxas then deletes the wgmmas that wrote them)
        "y_mask": [(f"requant(acc{a}, {sc})", f"(acc{a} & 127)")
                   for a, sc in (
            ("[mt][4 * j + 2 * hh]", "s1"), ("[mt][4 * j + 2 * hh + 1]", "s1"),
            ("[4 * j + 2 * hh]", "s2"), ("[4 * j + 2 * hh + 1]", "s2"))],
        "no_conv3_wgmma": [("wgmma_s8_ss_n128(acc[mt],",
                            "if (nq < 0) wgmma_s8_ss_n128(acc[mt],")],
        "no_out_store": [
            ("*reinterpret_cast<uint4*>(out + off + c0 + c * 8) =",
             "if (off == -7) *reinterpret_cast<uint4*>(out) =")],
        "no_conv3": [("if (p3 % kCons != wg || col0 >= cout) {",
                      "if (true) {")],
        # the producer arrives without bytes and loads no weight box
        "no_weight_tma": [
            ("if (tid == 0) mbar_arrive_tx(full + r.slot, kSlot);",
             "if (tid == 0) mbar_arrive(full + r.slot);"),
            ("tma_load_2d(ws, &m1,", "if (kc < 0) tma_load_2d(ws, &m1,"),
            ("tma_load_3d(ws, &m2,", "if (kc < 0) tma_load_3d(ws, &m2,"),
            ("tma_load_2d(ws, &m3,", "if (kc < 0) tma_load_2d(ws, &m3,")],
    }),
    "aspp": ("dcfp_aspp_fused", [_VP, _VP, _VP] + [_CI] * 10 + [_VP], {
        "base": [],
        "no_wgmma": [("wgmma_bf16_ss_n128(acc[mt],",
                      "if (steps < 0) wgmma_bf16_ss_n128(acc[mt],")],
        "no_weight_loads": [
            ("mbar_arrive_tx(full + r.slot, abytes + kBBytes);",
             "mbar_arrive_tx(full + r.slot, abytes);"),
            ("tma_load_3d(bs + r.slot * kBBytes,",
             "if (steps < 0) tma_load_3d(bs + r.slot * kBBytes,")],
        "no_x_loads": [
            ("mbar_arrive_tx(full + r.slot, abytes + kBBytes);",
             "mbar_arrive_tx(full + r.slot, kBBytes);"),
            ("tma_load_3d(as + (size_t)r.slot * abytes,",
             "if (steps < 0) tma_load_3d(as + (size_t)r.slot * abytes,")],
        "all_taps": [(
            "if (y0 + dy < h && y1 + dy >= 0 && x0 + dx < w && x1 + dx >= 0)",
            "if (dy > -1 << 30)")],
        # every x box from the first 64 channels: x's working set fits L2
        "x_in_l2": [("&mx, full + r.slot, c0,", "&mx, full + r.slot, 0,")],
    }),
}

# other tiles (R, S, stages) to time the base kernels on
K6_TILES = {"probe": [(8, 16, 2), (6, 21, 4), (11, 11, 4), (5, 25, 4)],
            "layer3": [(11, 11, 4), (10, 12, 4), (6, 21, 4)]}
K4_TILES = [(16, 16, 4), (4, 64, 4), (8, 16, 4), (8, 32, 3), (8, 32, 2)]


def build(jobs):
    """{(source, variant): C entry} for jobs {(source, variant): (source
    text, include dir)}, every library compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (source, name), (text, inc) in jobs.items():
        cu, so = OUT / f"{source}_{name}.cu", OUT / f"lib{source}_{name}.so"
        cu.write_text(text)
        procs[source, name] = (subprocess.Popen(
            [cb._nvcc(), *cb.NVCC_FLAGS, "-I", str(inc), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    fns = {}
    for (source, name), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k46_parts: nvcc failed for {source} {name}:"
                             f"\n{log}")
        entry, argtypes, _ = KERNELS[source]
        fn = getattr(ctypes.CDLL(str(so.resolve())), entry)
        fn.argtypes = argtypes
        fns[source, name] = fn
    return fns


def variants():
    """The build jobs of every variant: the tree's source with its edits."""
    jobs = {}
    for source, (_, _, parts) in KERNELS.items():
        src = (cb.CSRC_DIR / f"{source}.cu").read_text()
        for name, edits in parts.items():
            text = src
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"k46_parts: the hook of {source} {name}"
                                     f" is not in {source}.cu: {old[:60]!r}")
                text = text.replace(old, new)
            jobs[source, name] = (text, cb.CSRC_DIR)
    return jobs


def cases():
    """[(tag, source, C entry arguments before the tile, the planner's
    tile, other tiles, tensors to keep alive)]: K6 at both shapes, K4 at
    stage B."""
    out = []
    for seed, (shape, (h0, w, cin, cm, cout)) in enumerate(
            cs.K6_SHAPES.items(), 1):
        x8, w1, w2, w3 = cs._k6_inputs(h0, w, cin, cm, cout, seed)
        cw = int8.chain_int8_weights(w1, w2, w3)
        o = torch.empty((h0, w, cout), dtype=torch.bfloat16, device="cuda")
        head = (x8.data_ptr(), cw.w1.data_ptr(), cw.w2.data_ptr(),
                cw.w3.data_ptr(), *cs.K6_CHECK_SCALES, o.data_ptr(),
                h0 + 2 * int8.D, w, cin, cm, cout, int8.D)
        out.append((f"k6 {shape}", "int8_chain", head,
                    int8.chain_tile(h0, w, cin, cm, cout), K6_TILES[shape],
                    (x8, cw, o)))
    gen = torch.Generator(device="cuda").manual_seed(11)
    h, w, cin, cout = 129, 257, 2048, 128
    x = (torch.randn((h, w, cin), device="cuda", generator=gen).relu()
         * 0.5).to(torch.bfloat16)
    wt = aspp.aspp_kernel_weights((torch.randn(
        (27, cin, cout), device="cuda", generator=gen) * 0.01).to(
            torch.bfloat16))
    o = torch.empty((h, w, 3 * cout), dtype=torch.bfloat16, device="cuda")
    head = (x.data_ptr(), wt.data_ptr(), o.data_ptr(), h, w, cin, cout,
            *aspp.DILATIONS)
    out.append(("k4 stage B", "aspp", head, aspp.aspp_tile(h, w, cin, cout),
                K4_TILES, (x, wt, o)))
    return out


def time_ms(fn, *args):
    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return cs.cuda_ms(run, 30, 5)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None,
                    help="a directory with other int8_chain.cu, aspp.cu and "
                         "headers, timed in turns against the tree's")
    opts = ap.parse_args()
    cs.phase_device()
    if opts.against:
        other = Path(opts.against).resolve()
        fns = build({(s, v): ((d / f"{s}.cu").read_text(), d)
                     for s in KERNELS
                     for v, d in (("A", other), ("B", cb.CSRC_DIR))})
        for tag, source, head, tile, _, _ in cases():
            a, b = fns[source, "A"], fns[source, "B"]
            t = [time_ms(f, *head, *tile) for f in (a, b, b, a)]
            print(f"[k46_parts] {tag} tile {list(tile)}: A {t[0]:.4f} B "
                  f"{t[1]:.4f} B {t[2]:.4f} A {t[3]:.4f} ms", flush=True)
    else:
        fns = build(variants())
        for tag, source, head, tile, others, _ in cases():
            for (src, name), fn in fns.items():
                if src == source:
                    print(f"[k46_parts] {tag} tile {list(tile)} {name}: "
                          f"{time_ms(fn, *head, *tile):.4f} ms", flush=True)
            for other in others:
                print(f"[k46_parts] {tag} tile {list(other)} base: "
                      f"{time_ms(fns[source, 'base'], *head, *other):.4f} ms",
                      flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
