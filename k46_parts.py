"""Where K1's, K2's, K6's and K4's time goes: their kernels with parts
switched off, with design choices undone, on other tiles than the
planners', or against other copies of their sources, on one CUDA card.

    python3 k46_parts.py                  # parts, choices and tiles
    python3 k46_parts.py --sass           # also the bases' SASS counts
    python3 k46_parts.py --against DIR    # DIR's sources (A) vs the
                                          # tree's (B), in turns
    python3 k46_parts.py --source stem_conv   # one kernel only

Builds variants of ``dcfp_tpu_torch/csrc/resize_argmax.cu`` (K1),
``stem_conv.cu`` (K2), ``int8_chain.cu`` (K6) and ``aspp.cu`` (K4) into
``.chip_tree/k46_parts/`` (git-ignored), each with one source edit,
and times each through its C entry: K1 at the deploy shape (1 x 19 x
129 x 257 bf16 -> 1025 x 2049, align_corners, channels_last,
``chip_smoke.time_k1``'s input) and K2 at the deploy shape (1 x 12 x
536 x 1026 bf16 -> 64 x 513 x 1025 channels_last,
``chip_smoke.time_k2``'s input) in a CUDA graph, K6 at the int8 probe's
stage-B shape and the pruned R101's layer3 (``chip_smoke.py``'s inputs)
and K4 at the ASPP probe's stage B (129 x 257 x 2048 -> 3 x 128, seeded
like the served layer4 output) with CUDA events, 30 launches after 5.
The bases are also timed on tiles other than the planners'.

A variant that removes a part is wrong by design, and only its time
means something: a part costs at most base minus the variant without
it.  A variant that undoes a design choice (``CHOICES``: K2's threads
storing the runs in place of the bulk copy among them), and K1's and
K2's bases on other tiles (K2: other run lengths and grids), must give
the base's output bit for bit, and the script fails if they do not.
``--sass`` prints the opcode counts of every kernel of each base
library (``cuobjdump``) and writes its SASS beside the builds.
``--against DIR`` times DIR's copy of each source (an older version
with the same C entry; the headers are DIR's too) against the tree's in
turns, A, B, B, A; a source whose C entry differs in DIR is skipped,
and one whose C entry refuses the tree's plan is not timed, each with a
line that says so.

Prints the build's registers and spills, one line per case and variant
(or turn), then the card's name and power limit; exits non-zero without
a card, when a variant's hook is no longer in the source, or when a
choice's or a tile's labels differ.  About a minute on an H100, builds
included.
"""

import argparse
import collections
import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional

import torch

import chip_smoke as cs
from dcfp_tpu_torch.ops import aspp, int8, kernels
from dcfp_tpu_torch.ops import cuda_build as cb
from dcfp_tpu_torch.ops.kernels import _CF, _CI, _VP

OUT = Path(__file__).resolve().parent / ".chip_tree" / "k46_parts"

K1_W_PASS = ("// Step 3: the W pass of this chunk, four channels a load\n"
             "#pragma unroll\n    for (int cc = 0; cc < kChunk; cc += 4) {")

K2_STAGE = ("stage_run<true>(ph, r, S, P.line, stage + b * selems, warp, "
            "lane);")
K2_MMA = ('  asm volatile(\n'
          '      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "')

# source: (C entry, argtypes, {variant: [(text, replacement)]})
KERNELS = {
    "resize_argmax": ("dcfp_resize_argmax_cm", kernels.K1_ARGTYPES, {
        "base": [],
        # bf16 pixels one at a time: rounded, widened and compared in f32
        "no_pairs": [(
            "constexpr bool kBf16Pairs = std::is_same<T, __nv_bfloat16>::"
            "value;", "constexpr bool kBf16Pairs = false;")],
        # a thread's pixels adjacent, not tpr apart
        "adjacent": [("return q + k * tpr;", "return q * kPix + k;")],
        # registers uncapped: fewer blocks an SM
        "min_blocks_1": [("constexpr int kMinBlocks = 4;",
                          "constexpr int kMinBlocks = 1;")],
        # the W pass over the first 4 channels only (of 19)
        "w_pass_4ch": [(K1_W_PASS, K1_W_PASS.replace("cc < kChunk",
                                                     "cc < 4"))],
        # no footprint staging: the H pass reads what shared memory holds
        "no_stage": [("stage<T>(zs, zt, min(kChunk, C),",
                      "if (C < 0) stage<T>(zs, zt, min(kChunk, C),")],
        # no H pass: the W pass reads what shared memory holds
        "no_h_pass": [("h_pass(as, zs, rtap, rwt, min(kChunk, C),",
                       "if (C < 0) h_pass(as, zs, rtap, rwt, "
                       "min(kChunk, C),")],
    }),
    "stem_conv": ("dcfp_stem_conv3x3_s2", kernels.K2_ARGTYPES, {
        "base": [],
        # route (b) at the base's plan: the threads store each run
        "threads_store": [("static_cast<const float*>(bias), S, P,",
                           "static_cast<const float*>(bias), S, Plan{P.m, "
                           "P.line, P.cg, P.groups, P.load4, 0},")],
        # no footprint loads: A is built from what the stages hold
        "no_stage": [(K2_STAGE, "{ if (t < 0) " + K2_STAGE + " }")],
        # the 2-byte loads where the plan takes 4-byte cp.async
        "load2": [("if (P.load4)\n      stage_run<true>",
                   "if (false)\n      stage_run<true>")],
        # no tensor-core product; each accumulator still reads A and B
        "no_mma": [(K2_MMA, "if (b.x != 0x7f7f7f7fu) {\n" + "".join(
            f"    acc[{i}] += __uint_as_float((a[{i}] ^ b.{'xy'[i & 1]})"
            f" & 0x3f800000u);\n" for i in range(4))
            + "    return;\n  }\n" + K2_MMA)],
        # no output store: the runs stay in shared memory
        "no_store": [("bulk_store(dst, ob,",
                      "if (len < 0) bulk_store(dst, ob,")],
        # no quad transpose: each lane stores its own fragment words
        "no_transpose": [("quad_transpose(wv[0], tig);", ""),
                         ("quad_transpose(wv[1], tig);", "")],
        # no stores to the output buffer (the values still computed)
        "no_buffer_store": [(
            "if (lc < nch)\n                *reinterpret_cast",
            "if (lc < nch && v.x == 0x7fc17fc1u)\n"
            "                *reinterpret_cast")],
        # registers uncapped: launch bounds for one block an SM
        "min_blocks_1": [("constexpr int kMinBlocks = 2;",
                          "constexpr int kMinBlocks = 1;")],
        # 85 registers, three blocks an SM (at M = 128: ``K2_VTILES``)
        "min_blocks_3": [("constexpr int kMinBlocks = 2;",
                          "constexpr int kMinBlocks = 3;")],
    }),
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
# variants that must give the base's output bit for bit
CHOICES = {("resize_argmax", v) for v in ("no_pairs", "adjacent",
                                          "min_blocks_1")} | {
    ("stem_conv", v) for v in ("threads_store", "load2", "min_blocks_1",
                               "min_blocks_3")}

# other tiles to time the bases on: K1 (TR, TW), K6 and K4 (R, S, stages)
K1_TILES = [(4, 256), (8, 128), (4, 128), (16, 128), (2, 256)]
# K2 (run length M, grid): two, three and four blocks an SM
K2_TILES = [(128, 264), (128, 396), (128, 528), (256, 132), (64, 528)]
# K2 variants timed on another tile than the plan's
K2_VTILES = {"min_blocks_3": (128, 396)}
K6_TILES = {"probe": [(8, 16, 2), (6, 21, 4), (11, 11, 4), (5, 25, 4)],
            "layer3": [(11, 11, 4), (10, 12, 4), (6, 21, 4)]}
K4_TILES = [(16, 16, 4), (4, 64, 4), (8, 16, 4), (8, 32, 3), (8, 32, 2)]


@dataclasses.dataclass
class Case:
    tag: str
    source: str
    head: tuple          # C entry arguments before the tile
    tile: tuple          # the planner's tile arguments
    others: list         # other tile arguments
    keep: tuple          # tensors the arguments point into
    out: Optional[torch.Tensor] = None  # output checked against the base's
    graph: bool = False  # timed in a CUDA graph, else with CUDA events
    vtiles: dict = dataclasses.field(default_factory=dict)  # variant: tile


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
            raise SystemExit(f"k46_parts: nvcc failed for {source} {name}"
                             f":\n{log}")
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
        print(f"[k46_parts] built {source} {name}: registers {regs}, "
              f"spill stores {spills} bytes", flush=True)
        entry, argtypes, _ = KERNELS[source]
        fn = getattr(ctypes.CDLL(str(so.resolve())), entry)
        fn.argtypes = argtypes
        fns[source, name] = fn
    return fns


def variants(sources):
    """The build jobs of every variant: the tree's source with its edits."""
    jobs = {}
    for source in sources:
        src = (cb.CSRC_DIR / f"{source}.cu").read_text()
        for name, edits in KERNELS[source][2].items():
            text = src
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"k46_parts: the hook of {source} "
                                     f"{name} is not in {source}.cu: "
                                     f"{old[:60]!r}")
                text = text.replace(old, new)
            jobs[source, name] = (text, cb.CSRC_DIR)
    return jobs


def entry_decl(text, entry):
    """The C entry's declaration in a source, whitespace folded."""
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", text,
                  re.DOTALL)
    return " ".join(m.group(1).split()) if m else None


def k1_case():
    gen = torch.Generator(device="cuda").manual_seed(1)
    z = torch.randn(cs.MAIN_SHAPE, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    n, c, h, w = cs.MAIN_SHAPE
    (oh, ow), ac = cs.MAIN_OUT, True
    ytap, ywt = kernels._taps(h, oh, ac, z.device)
    xtap, xwt = kernels._taps(w, ow, ac, z.device)
    yi = kernels._tap_table(h, oh, ac)[0]
    xi = kernels._tap_table(w, ow, ac)[0]
    out = torch.empty((n, oh, ow), dtype=torch.uint8, device="cuda")

    def tile(tr, tw):
        sr, sc = kernels._max_span(yi, tr), kernels._max_span(xi, tw)
        return (tr, tw, kernels.K1_PIXELS, kernels.K1_CHUNK, sr, sc,
                kernels._k1_smem(tr, tw, sr, sc, c, kernels.K1_CHUNK))

    plan = kernels.resize_argmax_plan(n, c, h, w, oh, ow, ac)
    head = (z.data_ptr(), 1, n, c, *z.stride(), oh, ow, ytap.data_ptr(),
            ywt.data_ptr(), xtap.data_ptr(), xwt.data_ptr(), out.data_ptr())
    return Case("k1 deploy", "resize_argmax", head, tile(plan.tr, plan.tw),
                [tile(*t) for t in K1_TILES], (z, ytap, ywt, xtap, xwt),
                out, graph=True)


def k2_case():
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, h, w, cin, cout = cs.K2_CASES[-1]
    _, ph, k, b = cs._stem_inputs(n, h, w, cin, cout, gen)
    ph = ph.to(torch.bfloat16)
    km, bf = kernels.stem_weights(k.to(torch.bfloat16), b.to(torch.bfloat16),
                                  ph.dtype, ph.device)
    _, _, hp, wp = ph.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    out = torch.empty((n, ho, wo, cout), dtype=torch.bfloat16, device="cuda")
    plan = kernels.stem_conv_plan(n, cin, cout, hp, wp, ho, wo,
                                  kernels._ptr_align(ph.data_ptr()))

    def tile(m, grid):
        line = int(kernels.k2_runs(m, ho, wo)["width"].max())
        return (m, line, 1, 1, grid,
                kernels._k2_smem(cin, cout, m, line, 1, 1, True), 1, 1)

    head = (ph.data_ptr(), 1, n, cin, cout, hp, wp, ho, wo, km.data_ptr(),
            bf.data_ptr(), 0, out.data_ptr())
    return Case("k2 deploy", "stem_conv", head,
                kernels._k2_launch_args(plan),
                [tile(*t) for t in K2_TILES], (ph, km, bf), out, graph=True,
                vtiles={v: tile(*t) for v, t in K2_VTILES.items()})


def cases(sources):
    """The cases of ``sources``: K1 and K2 at the deploy shape, K6 at both
    shapes, K4 at stage B."""
    out = []
    if "resize_argmax" in sources:
        out.append(k1_case())
    if "stem_conv" in sources:
        out.append(k2_case())
    if "int8_chain" in sources:
        for seed, (shape, (h0, w, cin, cm, cout)) in enumerate(
                cs.K6_SHAPES.items(), 1):
            x8, w1, w2, w3 = cs._k6_inputs(h0, w, cin, cm, cout, seed)
            cw = int8.chain_int8_weights(w1, w2, w3)
            o = torch.empty((h0, w, cout), dtype=torch.bfloat16,
                            device="cuda")
            head = (x8.data_ptr(), cw.w1.data_ptr(), cw.w2.data_ptr(),
                    cw.w3.data_ptr(), *cs.K6_CHECK_SCALES, o.data_ptr(),
                    h0 + 2 * int8.D, w, cin, cm, cout, int8.D)
            out.append(Case(f"k6 {shape}", "int8_chain", head,
                            int8.chain_tile(h0, w, cin, cm, cout),
                            K6_TILES[shape], (x8, cw, o)))
    if "aspp" in sources:
        gen = torch.Generator(device="cuda").manual_seed(11)
        h, w, cin, cout = 129, 257, 2048, 128
        x = (torch.randn((h, w, cin), device="cuda", generator=gen).relu()
             * 0.5).to(torch.bfloat16)
        wt = aspp.aspp_kernel_weights((torch.randn(
            (27, cin, cout), device="cuda", generator=gen) * 0.01).to(
                torch.bfloat16))
        o = torch.empty((h, w, 3 * cout), dtype=torch.bfloat16,
                        device="cuda")
        head = (x.data_ptr(), wt.data_ptr(), o.data_ptr(), h, w, cin, cout,
                *aspp.DILATIONS)
        out.append(Case("k4 stage B", "aspp", head,
                        aspp.aspp_tile(h, w, cin, cout), K4_TILES,
                        (x, wt, o)))
    return out


def time_ms(case: Case, fn: Callable, tile) -> float:
    def run():
        err = fn(*case.head, *tile, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{case.tag}: CUDA error {err}")
    if case.graph:
        return cs.graph_ms(run)
    return cs.cuda_ms(run, 30, 5)


def sass_counts(source):
    """{kernel: opcode Counter} of ``source``'s base library; its SASS is
    written beside it."""
    tool = shutil.which("cuobjdump") or str(Path(cb._nvcc()).parent
                                            / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(OUT / f"lib{source}_base.so")],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    (OUT / f"{source}_base.sass").write_text(sass)
    counts = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", func)
        counts[func.split("\n")[0].strip()] = collections.Counter(
            op.split(".")[0] for op in ops)
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", action="store_true",
                    help="print the opcode counts of each base kernel")
    ap.add_argument("--against", default=None,
                    help="a directory with other copies of the sources and "
                         "their headers, timed in turns against the tree's")
    ap.add_argument("--source", action="append", choices=list(KERNELS),
                    help="only these sources (repeatable; default all)")
    opts = ap.parse_args()
    cs.phase_device()
    sources = opts.source or list(KERNELS)
    if opts.against:
        other = Path(opts.against).resolve()
        ab = []
        for s in sources:
            entry = KERNELS[s][0]
            theirs = other / f"{s}.cu"
            if not theirs.exists() or entry_decl(
                    theirs.read_text(), entry) != entry_decl(
                    (cb.CSRC_DIR / f"{s}.cu").read_text(), entry):
                print(f"[k46_parts] {s}: {entry} differs in {other}; "
                      f"not timed", flush=True)
            else:
                ab.append(s)
        fns = build({(s, v): ((d / f"{s}.cu").read_text(), d)
                     for s in ab
                     for v, d in (("A", other), ("B", cb.CSRC_DIR))})
        for case in cases(ab):
            a, b = fns[case.source, "A"], fns[case.source, "B"]
            try:
                t = [time_ms(case, f, case.tile) for f in (a, b, b, a)]
            except RuntimeError as e:  # A's C entry refused B's plan
                print(f"[k46_parts] {case.tag}: not timed, {e}", flush=True)
                continue
            print(f"[k46_parts] {case.tag} tile {list(case.tile)}: A "
                  f"{t[0]:.4f} B {t[1]:.4f} B {t[2]:.4f} A {t[3]:.4f} ms",
                  flush=True)
    else:
        fns = build(variants(sources))
        if opts.sass:
            for s in sources:
                for func, counts in sass_counts(s).items():
                    print(f"[k46_parts] {s} base SASS {func[:80]}: "
                          f"{sum(counts.values())} instructions; "
                          f"{dict(counts.most_common(24))}", flush=True)
        for case in cases(sources):
            base = fns[case.source, "base"]
            want = None
            if case.out is not None:
                time_ms(case, base, case.tile)
                want = case.out.clone()
            for (src, name), fn in fns.items():
                if src != case.source:
                    continue
                vt = case.vtiles.get(name, case.tile)
                ms = time_ms(case, fn, vt)
                same = ""
                if want is not None:
                    equal = bool(torch.equal(case.out, want))
                    if (src, name) in CHOICES and not equal:
                        raise SystemExit(f"k46_parts: {case.tag} {name} "
                                         f"changed the output")
                    same = f"; output equal to base {equal}"
                print(f"[k46_parts] {case.tag} tile {list(vt)} "
                      f"{name}: {ms:.4f} ms{same}", flush=True)
            for other in case.others:
                ms = time_ms(case, base, other)
                if want is not None and not torch.equal(case.out, want):
                    raise SystemExit(f"k46_parts: {case.tag} tile "
                                     f"{list(other)} changed the output")
                print(f"[k46_parts] {case.tag} tile {list(other)} base: "
                      f"{ms:.4f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
