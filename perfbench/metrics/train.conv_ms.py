"""Device ms a step in convolutions, forward and backward: cuDNN's kernels
and the GEMM kernels it runs 1x1 convolutions as.  The GEMMs of the loss
tail's bilinear resizes carry the same names and are counted here too."""


def read(w, ctx):
    return w.per_unit_ms("conv", "matmul")
