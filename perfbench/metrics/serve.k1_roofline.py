"""K1 (the resize-argmax tail) against its roofline: the least time its
shapes allow (``arith.k1_bound_s``) over its device time a request, in %.
Nothing when no K1 launch was traced."""


def read(w, ctx):
    k1 = w.classes.get("k1", 0.0) / w.units
    if k1 <= 0.0:
        return None
    return 100.0 * ctx["k1_bound_s"] / k1
