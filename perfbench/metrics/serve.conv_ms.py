"""Device ms a request in the graph body's convolutions: cuDNN's kernels,
and the GEMM kernels (``nvjet``) that cuDNN runs 1x1 convolutions as (the
body's only other matmul, the ASPP image pool's broadcast, is negligible)."""


def read(w, ctx):
    return w.per_unit_ms("conv", "matmul")
