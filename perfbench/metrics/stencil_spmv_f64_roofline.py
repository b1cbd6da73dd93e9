"""stencil_spmv_f64_roofline: ``stencil_spmv_kernel<double, double>``,
the f64 levels' and the f64 CG's instance, as a share of its roofline over
the traced window's launches on every level, in %
(``work/stencil_roofline.py``)."""
from perfbench.work.stencil_roofline import roofline


def read(ctx):
    return roofline(ctx, "double, double")
