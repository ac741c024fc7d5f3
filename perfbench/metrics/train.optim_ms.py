"""Device ms a step in the optimizer's and the EIC's multi-tensor kernels
(``torch._foreach_*``)."""


def read(w, ctx):
    return w.per_unit_ms("optim")
