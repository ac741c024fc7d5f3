"""Device ms a request in PyTorch's elementwise kernels (the bias add after
each conv, residual adds, ReLUs)."""


def read(w, ctx):
    return w.per_unit_ms("elementwise")
