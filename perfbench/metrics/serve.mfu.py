"""The whole request against the card's bf16 peak, in %: the model's FLOPs
a frame (``arith.macs``, two a MAC) over the wall time a request takes in
the measured (untraced) window, over 989 TFLOP/s."""


def read(w, ctx):
    return 100.0 * ctx["flops_per_unit"] / ctx["unit_s"] / ctx["peak_flops"]
