"""``vgg19_roofline.train_patch``: VGG19 against its bound over the
window's patch steps.

The bound of a patch step's VGG19 work (three crops forward, two input
gradients: the larger of its operations at the TF32 peak, 494.7 TFLOP/s,
and its least bytes at 3.35 TB/s, ``yardstick.counts_patch.vgg_bound_s``)
times the patch steps, over the device time of the operations launched
inside the program's ``patch.feature`` spans (VGG19's forward and the L1
terms) and inside ``aten::convolution_backward`` (VGG19's backward,
``yardstick.patch_trace``). Nothing to read without the spans."""

from yardstick import counts_patch


def read(ctx):
    c = ctx["counts"]
    dev = c.get("patch_device_s")
    if not dev or not c.get("patch_steps") or dev["patch.feature"] <= 0:
        return None
    cfg = ctx["plain"]
    bound = counts_patch.vgg_bound_s(cfg["vgg_layers"], cfg["nH"], cfg["nW"])
    return 100.0 * bound * c["patch_steps"] / (dev["patch.feature"] + dev["vgg_bwd"])
