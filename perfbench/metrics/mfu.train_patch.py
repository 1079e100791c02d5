"""``mfu.train_patch``: the whole patch cell's share of the card's bf16
peak.

Every step's base batch (both MLP passes forward and backward,
``yardstick.counts.step_flops``) and, on the patch steps, the no-grad
leg's two forward passes, the grad leg's forward and backward and VGG19's
three forward passes and two input gradients
(``yardstick.counts_patch.patch_flops``, over the patch steps and the
legs' rays that the program's ``patch.*`` counters counted), over the
traced window's seconds times 989 TFLOP/s. Nothing to read where the
program counts no patch steps."""

from yardstick import counts, counts_patch


def read(ctx):
    c = ctx["counts"]
    if not c.get("steps") or not c.get("patch_steps"):
        return None
    flops = (counts.step_flops(ctx["plain"], c["n_rays"]) * c["steps"]
             + counts_patch.patch_flops(ctx["plain"], c["patch_steps"],
                                        c["patch_rays_ng"], c["patch_rays_grad"]))
    return 100.0 * flops / (ctx["trace"].window_s * counts.PEAK_FLOPS_BF16 * c["chips"])
