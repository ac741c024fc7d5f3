"""Device ms a step in batch norm, forward and backward."""


def read(w, ctx):
    return w.per_unit_ms("bn")
