"""The share of a request's time in which the device ran nothing, in %: the
device's busy time a request in the traced window over the wall time a request
takes in the measured (untraced) window, so that the profiler's own cost
on the host is left out."""


def read(w, ctx):
    return 100.0 * (1.0 - w.busy_s / w.units / ctx["unit_s"])
