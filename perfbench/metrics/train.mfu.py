"""The whole step against the card's TF32 peak, in %: the step's FLOPs
(three forward passes' worth, ``arith.macs``, two a MAC) over the wall
time a step takes in the measured (untraced) window, over 495 TFLOP/s
(the convs run in TF32)."""


def read(w, ctx):
    return 100.0 * ctx["flops_per_unit"] / ctx["unit_s"] / ctx["peak_flops"]
