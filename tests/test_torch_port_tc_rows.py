"""The bfloat16 forward tile's tensor-core weight rows on the CPU
(``pack_params``' ``weights_p``, read by ``csrc/fused_nerf.cuh:tc_layer``):
unpacked, each padded layer gives the layer's ``Linear.weight`` ``[out, in]``
(views_0: its W feature columns) exactly, and every pad is exactly zero.
Also the float64 witness that holds the tile's bfloat16 products on the
card (``fused_mlp_t.bf16_product_witness``)."""

import numpy as np
import pytest
import torch


def _unpermute(rows, out):
    """Undo the kernel's order of each run of 16 k: position 4t + j holds
    k = (2t, 2t + 1, 2t + 8, 2t + 9)[j], lane t's two mma B registers."""
    k_of = [k for t in range(4) for k in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
    r = rows.reshape(out, -1, 16)
    plain = torch.empty_like(r)
    plain[..., k_of] = r
    return plain.reshape(out, -1)


@pytest.mark.parametrize("depth,width,multires,multires_views", [
    (4, 256, 10, 4), (8, 256, 10, 4), (8, 128, 4, 2), (2, 128, 10, 4)])
def test_tc_rows_unpack_to_the_layer_weights(depth, width, multires,
                                             multires_views):
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    e_p, e_v = 3 + 6 * multires, 3 + 6 * multires_views
    m = NeRFMLP(depth=depth, width=width, in_channels=e_p,
                in_channels_views=e_v, skips=(4,),
                generator=torch.Generator().manual_seed(depth + width))
    params = dict(m.named_parameters())
    pk = f.pack_params(params, depth, torch.bfloat16)
    assert f.pack_params(params, depth, torch.float32).weights_p is None
    wp, names = pk.weights_p, f._layer_names(depth)
    assert wp.dtype == torch.bfloat16 and len(pk.p_offsets) == depth + 4
    used = 0
    for i, name in enumerate(names):
        w = params[f"{name}.weight"].detach().to(torch.bfloat16)
        if name in ("sigma", "rgb"):  # on FMA, not in the buffer
            continue
        if name == "trunk_0":
            segs = [e_p]
        elif name.startswith("trunk_"):
            segs = [e_p, width] if w.shape[1] == e_p + width else [width]
        else:  # feature, views_0: the W activation columns
            segs = [width]
        pads = [-(-k // 16) * 16 for k in segs]
        n = w.shape[0] * sum(pads)
        assert pk.p_offsets[i] == used and pk.p_offsets[i] % 16 == 0
        rows = _unpermute(wp[used:used + n], w.shape[0])
        used += n
        o = po = 0
        for k, kp in zip(segs, pads):
            assert torch.equal(rows[:, po:po + k], w[:, o:o + k]), name
            assert (rows[:, po + k:po + kp] == 0).all(), name
            o, po = o + k, po + kp
    assert used == wp.numel()


def _exact_acts(f, params, enc, encv, S, depth, width, skips):
    """Kernel 4's activation buffer as float64 products of the bfloat16
    operands, each activation rounded once to bfloat16."""
    w, b = f._plain_weights(params, torch.bfloat16)

    def lin(x, name, cols=slice(None)):
        return x.double() @ w(name)[:, cols].double().T

    def rnd(z):
        return z.float().to(torch.bfloat16).float()

    hs, h = [], enc
    for i in range(depth):
        x = torch.cat([enc, h], 1) if (i - 1) in f.live_skips(depth, skips) \
            else h
        h = rnd(torch.relu(lin(x, f"trunk_{i}") + b(f"trunk_{i}").double()))
        hs.append(h)
    feat = rnd(lin(h, "feature") + b("feature").double())
    hv_ray = rnd(lin(encv, "views_0", slice(width, None)))
    hv = rnd(torch.relu(lin(feat, "views_0", slice(0, width))
                        + hv_ray.double().repeat_interleave(S, dim=0)
                        + b("views_0").double()))
    return torch.cat([a.to(torch.bfloat16).reshape(-1)
                      for a in hs + [feat, hv]])


@pytest.mark.parametrize("depth,S,skips", [(4, 64, ()), (8, 16, (4,))])
def test_bf16_product_witness_on_cpu(monkeypatch, depth, S, skips):
    """Activations rounded once from float64 products are exact for the
    witness in every layer; one moved by one bfloat16 step counts as one
    off its layer; a layer whose output channels come in another order is
    off nearly everywhere. The float32 share is reported per layer too.
    Both sides take one set of encodings: two calls of
    ``_plain_encodings`` on one input have given bfloat16 encodings that
    differ in a few thousand of 50 x 64,512 values within one test process
    (torch's CPU ``sin``/``cos``; the cause is not measured), and one
    encoding rounded the other way moves a point's whole first layer."""
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    N, width = 16, 256
    m = NeRFMLP(depth=depth, width=width, skips=skips,
                generator=torch.Generator().manual_seed(depth))
    params = {k: v.detach() for k, v in m.named_parameters()}
    rng = np.random.default_rng(depth)
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, N * S)).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(N, 3)).astype(np.float32)), dim=-1).T.contiguous()
    kw = dict(depth=depth, width=width, multires=10, multires_views=4,
              skips=skips)
    encs = f._plain_encodings(pts, vd, 10, 4, torch.bfloat16)
    monkeypatch.setattr(f, "_plain_encodings", lambda *a: encs)
    acts = _exact_acts(f, params, *encs, S, depth, width, skips)
    got = f.bf16_product_witness(params, pts, vd, acts, S, **kw)
    assert got["kernel"] == [0.0] * (depth + 2)
    assert len(got["float32"]) == depth + 2

    P, n = N * S, N * S * width
    bumped = acts.clone()
    i = n + int(torch.nonzero(acts[n:2 * n])[0])  # layer 1's first nonzero
    bumped.view(torch.int16)[i] += 1  # one bfloat16 step up
    moved = f.bf16_product_witness(params, pts, vd, bumped, S, **kw)
    assert moved["kernel"][:2] == [0.0, 1 / n]
    swapped = acts.clone()
    layer = swapped[n:2 * n].view(P, width)
    layer[:] = layer.flip(1)
    assert f.bf16_product_witness(params, pts, vd, swapped, S,
                                  **kw)["kernel"][1] > 0.5
