"""The numbers that decide ``correct`` in a patch cell: those of
:func:`yardstick.check.train_numbers` over the checked steps (each step's
loss gap and depth term and each leaf's change after the steps, from each
side's own steps; the gradient and its norms of the last checked step,
the patch step, both taken at the plain reference's parameters and Adam
moments before that step, which the program is fed), ``grad1_diff``
(:func:`yardstick.check.grad_diff` of step 1's gradient, a base step from
the shared initial weights), and the gaps of the patch step's own terms
(at the reference's parameters too): ``feature_gap`` (both passes'
content loss), ``feature0_gap`` (the coarse pass's) and ``inv_gap`` (the
smoothness), each ``|got - ref| / |ref|``. A term the program did not
report reads 0 against the reference's.

``vgg_gap`` holds VGG19 to the precision the configuration states: the
taps the program's VGG19 gave in the last step, against the reference's
VGG19 in float32 on the same inputs (the program's own normalised crops),
``sum |got - ref| / sum |ref|`` of the worst tap over the step's calls.
The rendered crops differ between the two sides by the MLPs' precision
and nine steps of training; this number sees VGG19 alone."""

from __future__ import annotations

import statistics
from typing import Dict

import torch

from yardstick import check
from yardstick.reference import Readings, plain_float32
from yardstick.reference_patch import vgg_features

TERMS = {"feature_loss": "feature_gap", "feature_loss0": "feature0_gap",
         "inv_loss": "inv_gap"}


def numbers(prog, ref, vgg=None, taps=()) -> Dict[str, float]:
    """``prog`` and ``ref`` are :class:`yardstick.reference_patch.PatchReadings`;
    ``vgg`` VGG19's weights and ``taps`` the configuration's taps, where the
    last step has VGG19 calls."""
    out = check.train_numbers(prog.readings, ref.readings)
    if ref.first:
        out["grad1_diff"] = grad1_diff(prog.first, ref.first)
    for key, name in TERMS.items():
        if key in ref.patch:
            out[name] = abs(prog.patch.get(key, 0.0) - ref.patch[key]) / abs(ref.patch[key])
    if ref.vgg:
        out["vgg_gap"] = vgg_gap(prog.vgg, vgg, taps) if prog.vgg else 1.0
    return out


def grad1_diff(got, want) -> float:
    """:func:`yardstick.check.grad_diff` of step 1's leaf gradients, over the
    leaves that :func:`yardstick.check.train_numbers` keeps."""
    norms = {k: float(torch.linalg.norm(g)) for k, g in want.items()}
    med = statistics.median(norms.values())
    keep = [k for k, g in norms.items() if g >= check.SMALL_GRAD * med]
    return check.grad_diff(Readings([], [], {}, {}, got),
                           Readings([], [], norms, {}, want), keep)


def vgg_gap(calls, vgg, taps) -> float:
    num = {t: 0.0 for t in taps}
    den = {t: 0.0 for t in taps}
    with plain_float32(), torch.no_grad():
        for x, got in calls:
            want = vgg_features(vgg, taps, x.float())
            for t in taps:
                num[t] += float((got[t].float() - want[t]).abs().sum())
                den[t] += float(want[t].abs().sum())
    return max(num[t] / den[t] for t in taps)
