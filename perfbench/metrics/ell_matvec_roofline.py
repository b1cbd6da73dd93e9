"""ell_matvec_roofline: the AMG fine level's block-ELL product
(``ops/assemble.ell_matvec``: PyTorch's gather, product and sum kernels)
as a share of its roofline, in %.

A probe, not the window's own launches: the product is three of
PyTorch's generic kernels, which the trace cannot tell from the cycle's
other gathers, products and sums. So once the traced window has closed,
the solver's own level-0 operator (the public ``levels[0].blocks`` and
``.adj``) is multiplied 50 times by one random x on the device, timed by
CUDA events: the bytes of the blocks, the adjacency, x and y
(``ell_matvec_work``) at the card's bandwidth over the time per product.
Nothing to read without AMG levels, or where the traced window holds no
gather (the product did not run there)."""
import torch

from perfbench.tracing import event_ms
from perfbench.work.kernels import bound_s, ell_matvec_work


def read(ctx):
    levels = getattr(ctx.system, "levels", None)
    if ctx.trace is None or ctx.device.type != "cuda" or not levels:
        return None
    fine = levels[0]
    blocks, adj = getattr(fine, "blocks", None), getattr(fine, "adj", None)
    if blocks is None or adj is None or not any("gather" in name for name in ctx.trace["kernels"]):
        return None
    from fem_shell_tpu_torch.ops.assemble import ell_matvec

    g = torch.Generator(device=ctx.device).manual_seed(11)
    x = torch.randn((blocks.shape[0], 6), generator=g, device=ctx.device, dtype=blocks.dtype)
    ms = event_ms(lambda: ell_matvec(blocks, adj, x), 50)
    nbytes, flops = ell_matvec_work(blocks, adj, x)
    return 100.0 * bound_s(nbytes, flops, blocks.element_size(), ctx.card_name) * 1e3 / ms
