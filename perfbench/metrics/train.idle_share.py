"""The share of a step's time in which the device ran nothing, in %: the
device's busy time a step in the traced window over the wall time a step
takes in the measured (untraced) window, so that the profiler's own cost
on the host is left out."""


def read(w, ctx):
    return 100.0 * (1.0 - w.busy_s / w.units / ctx["unit_s"])
