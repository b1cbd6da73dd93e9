"""stencil_spmv_f32_roofline: ``stencil_spmv_kernel<float, float>``, the
f32 V-cycle's instance, as a share of its roofline over the traced
window's launches on every level, in % (``work/stencil_roofline.py``)."""
from perfbench.work.stencil_roofline import roofline


def read(ctx):
    return roofline(ctx, "float, float")
