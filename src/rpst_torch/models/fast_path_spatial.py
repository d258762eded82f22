"""Row-sharded ("spatial") folded serving and training of multi_adain,
sel_multi_adain and ccam, row-sharded serving of sanet and dynamic_sanet
(``stylize_sanet_spatial``), and row-sharded serving of the standard
layout of every other network but mst (``stylize_std_spatial``); port of
``rpst.models.fast_path_spatial`` and of rpst's GSPMD serving route
(``serve.py:246-281``).

rpst runs the folded stylize inside one ``shard_map`` over a mesh's
``spatial`` axis. Here every rank runs the same folded bodies
(``models.fast_path``) on its own share of the image rows, each cross-row
dependency an explicit collective of ``rpst_torch.dist``:

  * **halo rows**: each stride-1 folded conv reads one folded row from each
    neighbour share (``dist.halo_rows``; the reflect ring at the image's
    top and bottom), the same values one device reads. A layer whose 4C and
    4Co are multiples of 128 (rpst's gate, :77-78) runs B1 with those rows
    as its ``rings`` through ``FoldedConvActHalo``, whose backward is B2
    with ``row_rings=False``, the rows' gradients and B3 with the same
    rings; the 3 <-> hidden end layers run the halo-padded plain conv
    (:84-89), differentiable by autograd;
  * **statistics**: AdaIN's instance sums, the SE pool, the CCAM energies,
    the VGG taps' statistics and the losses' sums are all-reduced over the
    axis (``dist.all_reduce``), BatchNorm's batch sums over every axis of
    the mesh (``dist.over_batch``), in the forward and the backward.

Training (``loss_spatial``) runs the frozen VGG in the standard layout on
the row share as rpst does (``_vgg_taps_spatial`` :603: halo-exchanged
reflect convs, row-local exact 2x2 pools), so the loss is the global one
on every rank, and the gradients are averaged over the mesh by the step.
A row share needs three VGG pools and two relu4_1 rows: img_size % (16 x
spatial) == 0 (rpst's rule); serving needs two folded rows a share:
img_size % (4 x spatial) == 0.

The standard layout (``stylize_std_spatial``) is rpst's GSPMD partitioning
made explicit: the bundle's one-device ``stylize`` runs on the row shares
inside ``dist.row_shares``, where the port's shared primitives (``nn.rows``
/ ``nn.blocks`` pads, padded convs and pools, ``ops.stats``, ``ops.wct``,
the SE / SK pools, the CCAM energies, LD's resize) exchange halo rows and
sum their statistics over the shares, and a tensor that stops splitting
evenly runs whole on every rank. Its only height rule is rpst's:
img_size % spatial == 0. It launches no kernel of the port, as rpst's
GSPMD route reaches no Pallas call. Its training (``loss_std_spatial``)
runs the one-device standard loss the same way, for every network but mst
(the ``model`` axis beside ``spatial`` too, ``train.step``'s "rows"
route): the frozen VGG's taps, the losses' means (``models.base.
feature_mse``), BatchNorm's and the segmentation loss's sums over the
shares; the MRF term gathers its two relu4_1 features whole; sanet's
attention is the port's one-device kernel on a shard, B6b with LSE and
B6c / B6d backward on the share's query rows against the gathered style
(rpst's GSPMD step computes the same function densely).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..dist import (Mesh, all_reduce, halo_pad, halo_rows, over_batch,
                    row_shares)
from ..nn.vgg import _STAGES, VGG19Encoder
from ..ops.folded import _pad_cols_ring, conv_nhwc
from ..ops.folded_conv import folded_conv_act_halo
from .fast_path import (_folded_ccam, _folded_se_bottleneck,
                        live_folded_blocks)
from .fast_path_q8_std import _maxpool2x_any

SPATIAL_FAMILIES = ("multi_adain", "ccam", "sel_multi_adain")


def _acc_type(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def check_height(h: int, spatial: int, train: bool) -> None:
    """rpst's height rules: a training share holds three VGG pools and two
    relu4_1 rows (h % (16 spatial)); a serving share two folded rows
    (h % (4 spatial))."""
    step = (16 if train else 4) * spatial
    if h % step:
        raise ValueError(f"image height {h} must be a multiple of {step} "
                         f"({'training' if train else 'serving'} on "
                         f"{spatial} row shares)")


def conv_lrelu_halo(x_l, k, b, mesh: Mesh, listed: bool = False):
    """One folded conv + bias + lrelu on a row share (rpst
    ``_conv_lrelu_halo`` :64), differentiable: lane-filling layers through
    ``FoldedConvActHalo`` (B1 / B2 / B3 on the card), the end layers on the
    halo-padded slab in plain PyTorch."""
    above, below = halo_rows(x_l, mesh.axis("spatial"))
    if k.shape[2] % 128 == 0 and k.shape[3] % 128 == 0:
        return folded_conv_act_halo(x_l, k, b, above.to(x_l.dtype),
                                    below.to(x_l.dtype), 0.2, listed)
    xp = torch.cat([above.to(x_l.dtype), x_l, below.to(x_l.dtype)], dim=1)
    y = conv_nhwc(_pad_cols_ring(xp), k) + b
    return torch.where(y >= 0, y, 0.2 * y)


def _folded_stats(x_f, mesh: Mesh, eps: float = 1e-5):
    """``ops.folded.folded_calc_mean_std`` over the whole image: the
    share's row sums (float32 rows, float64 across them, as one device
    sums) all-reduced over ``spatial``."""
    n, hh, ww, c4 = x_f.shape
    c = c4 // 4
    ax = mesh.axis("spatial")
    m = hh * ww * 4 * ax.size
    acc = _acc_type(x_f)
    v = x_f.to(acc).reshape(n, hh, ww * 4, c)
    sums = all_reduce(torch.stack([v.sum(dim=2).double().sum(dim=1),
                                   (v * v).sum(dim=2).double().sum(dim=1)]),
                      ax)
    mean = sums[0] / m
    var = ((sums[1] - m * mean * mean) / max(m - 1, 1)).to(acc)
    std = torch.sqrt(torch.clamp(var, min=0.0) + eps)
    tile = lambda t: t.repeat(1, 4)[:, None, None, :].to(x_f.dtype)  # noqa
    return tile(mean.to(acc)), tile(std)


def folded_adain_spatial(content_f, style_f, mesh: Mesh, eps: float = 1e-5):
    """``ops.folded.folded_adain`` with the instance statistics of the whole
    image (rpst ``_folded_adain_spatial`` :91)."""
    cm, cs = _folded_stats(content_f, mesh, eps)
    sm, ss = _folded_stats(style_f, mesh, eps)
    return (content_f - cm) / cs * ss + sm


def zero_conv_halo(x_l, k, mesh: Mesh):
    """The folded zero-pad 3x3 conv on a row share (rpst ``_zero_conv_halo``
    :195): the neighbours' edge rows, zero rows at the image's edges."""
    above, below = halo_rows(x_l, mesh.axis("spatial"),
                             reflect=lambda x, top: torch.zeros_like(x[:, :1]))
    xp = F.pad(torch.cat([above, x_l, below], dim=1), (0, 0, 1, 1))
    return conv_nhwc(xp, k)


def channel_pool_spatial(x_f, mesh: Mesh):
    """``ops.folded.folded_channel_pool`` over the whole image (rpst
    ``_channel_pool_spatial`` :219): (N, C) in x_f's type."""
    n, hh, ww, c4 = x_f.shape
    ax = mesh.axis("spatial")
    s = x_f.reshape(n, hh * ww, 4, c4 // 4).to(_acc_type(x_f)).sum(
        dim=(1, 2))
    return (all_reduce(s, ax) / (hh * ww * 4 * ax.size)).to(x_f.dtype)


def spatial_ops(mesh: Mesh, train: bool = False) -> Tuple[dict, object]:
    """(ops, conv) for ``ModelBundle.stylize_folded`` on a row share: the
    halo conv (B3's listed mode in training: the live fold's kernels), the
    all-reduced AdaIN, the SE bottleneck with its halo 3x3 conv and pool
    (rpst ``_se_bottleneck_spatial`` :231 / ``_train_spatial`` :831) and
    the CCAM with its energies all-reduced (``_ccam_spatial`` :311)."""
    def bottleneck(x_f, se, dtype, train_bn):
        return _folded_se_bottleneck(
            x_f, se, dtype, train_bn,
            conv3x3=lambda x, k: zero_conv_halo(x, k, mesh),
            pool=lambda x: channel_pool_spatial(x, mesh))

    ops = {
        "adain": lambda c, s: folded_adain_spatial(c, s, mesh),
        "bottleneck": bottleneck,
        "ccam": lambda x, y, scale: _folded_ccam(
            x, y, scale, reduce=lambda e: all_reduce(e, mesh.axis(
                "spatial"))),
    }
    return ops, (lambda x, k, b: conv_lrelu_halo(x, k, b, mesh, train))


def _family_ops(bundle, ops: dict) -> dict:
    keep = {"multi_adain": ("adain",),
            "sel_multi_adain": ("adain", "bottleneck"),
            "ccam": ("adain", "ccam")}[bundle.network]
    return {k: ops[k] for k in keep}


def _check_family(bundle) -> None:
    if bundle.network not in SPATIAL_FAMILIES or not bundle.folded_infer():
        raise ValueError(
            f"row-sharded (spatial) folded execution of {bundle.network} "
            f"(exec_strategy {bundle.cfg.get('exec_strategy', 'standard')}) "
            "is for the folded multi_adain, sel_multi_adain and ccam; the "
            "standard layout serves row-sharded through stylize_std_spatial "
            "(sanet and dynamic_sanet through stylize_sanet_spatial) and "
            "trains row-sharded through loss_std_spatial")


def stylize_spatial(bundle, content_l, style_l, mesh: Mesh,
                    dtype=None) -> torch.Tensor:
    """The folded stylize of this rank's row share (rpst
    ``stylize_multi_adain_folded_spatial`` :138, ``_sel_..._spatial`` :263,
    ``stylize_ccam_folded_spatial`` :338): (n, H / spatial, W, 3) content
    and style rows of one image batch -> the stylized rows, float32. Every
    rank of the ``spatial`` axis calls it together."""
    _check_family(bundle)
    check_height(content_l.shape[1] * mesh.spatial, mesh.spatial, False)
    dtype = dtype or bundle.folded_dtype()
    ops, conv = spatial_ops(mesh)
    with torch.inference_mode():
        return bundle.stylize_folded(
            bundle.folded_weights(dtype), bundle.folded_extras(dtype),
            content_l, style_l, dtype, conv=conv,
            ops=_family_ops(bundle, ops)).float()


# ---------------------------------------------------------------- training

def reflect_conv_halo_std(x_l, w, b, mesh: Mesh, act: bool = True):
    """A standard-layout reflect-pad 3x3 conv (+ relu) on a row share (rpst
    ``_reflect_conv_halo_std`` :403): NHWC x, OIHW w, the one-row reflect
    halo of ``dist.halo_pad``; 1x1 convs are row-local."""
    if w.shape[-1] == 1:
        y = conv_nhwc(x_l, w.permute(2, 3, 1, 0)) + b
    else:
        xp = halo_pad(x_l, 1, "reflect", mesh.axis("spatial"), dim=1)
        xp = torch.cat([xp[:, :, 1:2], xp, xp[:, :, -2:-1]], dim=2)
        y = conv_nhwc(xp, w.permute(2, 3, 1, 0)) + b
    return F.relu(y) if act else y


def vgg_taps_spatial(vgg: VGG19Encoder, x_l, mesh: Mesh, dtype):
    """[relu1_1 .. relu4_1] of a row share through the frozen 4-stage VGG
    (rpst ``_vgg_taps_spatial`` :603): halo-exchanged reflect convs and
    row-local exact 2x2 pools (the ceil-mode pool at the even sizes a
    share has)."""
    def conv(i, x, act=True):
        c = vgg.conv(i)
        return reflect_conv_halo_std(x, c.weight.to(dtype), c.bias.to(dtype),
                                     mesh, act)

    x = conv(0, x_l.to(dtype), act=False)   # the 1x1 normalization head
    x = conv(1, x)                           # relu1_1
    taps, idx = [x], 2
    for stage in range(2, 5):
        for j in range(len(_STAGES[stage - 1])):
            if j == len(_STAGES[stage - 1]) - 1:
                x = _maxpool2x_any(x)
            x = conv(idx, x)
            idx += 1
        taps.append(x)
    return taps


def tap_stats_spatial(x_l, mesh: Mesh, eps: float = 1e-5):
    """(mean, std), each (N, C), over the whole image of a row-sharded tap
    (rpst ``_tap_stats_spatial`` :625: ``calc_mean_std``'s unbiased
    variance, eps inside the sqrt), the sums all-reduced."""
    n, hh, ww, c = x_l.shape
    ax = mesh.axis("spatial")
    m = hh * ww * ax.size
    acc = _acc_type(x_l)
    v = x_l.to(acc)
    sums = all_reduce(torch.stack([v.sum(dim=(1, 2)).double(),
                                   (v * v).sum(dim=(1, 2)).double()]), ax)
    mean = sums[0] / m
    var = (sums[1] - m * mean * mean) / max(m - 1, 1)
    std = torch.sqrt(torch.clamp(var, min=0.0) + eps)
    return mean.to(acc), std.to(acc)


def perceptual_rp_losses_spatial(vgg: VGG19Encoder, stylized_l, style_l,
                                 content_l, mesh: Mesh, dtype):
    """``models.base.perceptual_rp_losses`` on row shares (rpst
    ``_perceptual_rp_losses_spatial`` :643): the style-statistics MSE over
    relu1..4_1 and the relu4_1 content MSE, every reduction a local sum
    all-reduced, so each rank holds the GLOBAL losses."""
    data, spatial = mesh.axis("data"), mesh.axis("spatial")
    n_local = style_l.shape[0]
    n_global = n_local * data.size
    g_taps = vgg_taps_spatial(vgg, stylized_l, mesh, dtype)
    with torch.no_grad():
        t_taps = vgg_taps_spatial(vgg, torch.cat([style_l, content_l]),
                                  mesh, dtype)
    loss_s = 0.0
    for g, t in zip(g_taps, t_taps):
        gm, gs = tap_stats_spatial(g, mesh)
        with torch.no_grad():
            tm, ts = tap_stats_spatial(t[:n_local], mesh)
        sq = ((gm - tm) ** 2).sum() + ((gs - ts) ** 2).sum()
        loss_s = loss_s + all_reduce(sq, data) / (n_global * gm.shape[-1])
    g4 = g_taps[-1].float()
    t4 = t_taps[-1][n_local:].float()
    _, h4, w4, c4 = g4.shape
    loss_c = (all_reduce(((g4 - t4) ** 2).sum(), (data, spatial))
              / (n_global * h4 * w4 * spatial.size * c4))
    return {"style_loss": loss_s, "content_loss": loss_c}


def loss_spatial(bundle, vgg: VGG19Encoder, content_l, style_l,
                 mesh: Mesh) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, parts) of the row-sharded folded training loss (rpst
    ``loss_and_grads_{multi_adain,ccam,sel}_folded_spatial`` :741 / :771 /
    :904), the GLOBAL loss on every rank, differentiable in the model's
    parameters through this rank's share; the step averages the
    parameters' gradients over the mesh (``dist.average_grads``).
    sel_multi_adain's BatchNorms take the batch statistics of every rank
    and move the running ones by them, the same on every rank."""
    _check_family(bundle)
    check_height(content_l.shape[1] * mesh.spatial, mesh.spatial, True)
    c = bundle.cfg
    dtype = bundle.folded_dtype()
    ops, conv = spatial_ops(mesh, train=True)
    with over_batch(mesh.reduce_axes()):
        stylized = bundle.stylize_folded(
            live_folded_blocks(bundle.model, dtype),
            bundle.folded_extras(dtype, live=True), content_l, style_l,
            dtype, conv=conv, train=True, ops=_family_ops(bundle, ops))
    parts = perceptual_rp_losses_spatial(vgg, stylized, style_l, content_l,
                                         mesh, dtype)
    total = (c.content_weight * parts["content_loss"]
             + c.style_weight * parts["style_loss"])
    return total, {**parts, "total_loss": total}


# ------------------------------------------------- SANet / AdaptiveSANet

SANET_FAMILIES = ("sanet", "dynamic_sanet")


def check_sanet_height(h: int, spatial: int) -> None:
    """rpst's rule (:538-542): four VGG pools and two relu5_1 rows a row
    share, h % (32 spatial) == 0."""
    if h % (32 * spatial):
        raise ValueError(f"image height {h} must be a multiple of "
                         f"{32 * spatial} (four VGG pools and two relu5_1 "
                         f"rows on each of {spatial} row shares)")


def mvn_spatial(x_l, mesh: Mesh, eps: float = 1e-5):
    """``ops.stats.mean_variance_norm`` of a row-sharded NHWC tap (rpst
    ``_mvn_spatial`` :436): float32 mean and unbiased variance over the
    whole image's H W, the sums all-reduced over ``spatial``; the result in
    x's type."""
    n, hh, ww, c = x_l.shape
    ax = mesh.axis("spatial")
    m = hh * ww * ax.size
    v = x_l.float()
    sums = all_reduce(torch.stack([v.sum(dim=(1, 2), keepdim=True),
                                   (v * v).sum(dim=(1, 2), keepdim=True)]),
                      ax)
    mean = sums[0] / m
    var = (sums[1] - m * mean * mean) / max(m - 1, 1)
    std = torch.sqrt(torch.clamp(var, min=0.0) + eps)
    return ((v - mean) / std).to(x_l.dtype)


def _conv1x1(x, conv, dtype):
    """rpst's ``_conv1x1_p`` (:453): a 1x1 conv of NHWC ``x`` in ``dtype``
    (input, weight and bias cast to it)."""
    from .sanet import conv1x1_nhwc
    return conv1x1_nhwc(x.to(dtype), conv.weight.to(dtype),
                        conv.bias.to(dtype))


def sanet_attention_spatial(att, content_l, style_full, dtype, mesh: Mesh,
                            adaptive: bool = False, ada_module: str = "aea"):
    """One (adaptive) SANet attention module on this rank's content rows
    against the whole style (rpst ``_sanet_attention_spatial`` :460): f on
    the whole image's mean-variance norm of the rows, g and h on the style,
    all in ``dtype``; the static module on B6 (``ops.flash_attention``:
    this shard's query rows, the bfloat16 instance in bfloat16), the
    adaptive one through its factorized psi0 / psi1 thresholds (per query,
    so row-local) and the streamed adaptive attention; out_conv plus the
    content rows."""
    from ..ops.adaptive_attention import adaptive_reweighted_attention
    from ..ops.affinity import l2_normalize_channels
    from ..ops.flash_attention import sanet_attention
    from ..ops.stats import mean_variance_norm
    from .sanet import AEA_SCALE, VARIANT, aea_thresholds_factorized
    f = _conv1x1(mvn_spatial(content_l, mesh), att.f, dtype)
    g = _conv1x1(mean_variance_norm(style_full), att.g, dtype)
    h = _conv1x1(style_full, att.h, dtype)
    n, hc, wc, c = f.shape
    hw_s = g.shape[1] * g.shape[2]
    fm, gm, hm = (f.reshape(n, hc * wc, c), g.reshape(n, hw_s, c),
                  h.reshape(n, hw_s, c))
    if adaptive:
        cn = l2_normalize_channels(content_l.reshape(n, hc * wc, -1).float())
        sn = l2_normalize_channels(style_full.reshape(n, hw_s, -1).float())
        layer = att.attention_layer
        psi = [(m.weight.float(), m.bias.float())
               for m in (layer.f_psi[0], layer.f_psi[2])]
        clamp = aea_thresholds_factorized(cn, sn, *psi, ada_module)
        o = adaptive_reweighted_attention(fm, gm, hm, clamp.to(fm.dtype),
                                          VARIANT[ada_module], AEA_SCALE)
    else:
        o = sanet_attention(fm, gm, hm)
    return _conv1x1(o.reshape(n, hc, wc, c), att.out_conv, dtype) \
        + content_l.to(dtype)


def _vgg_program(num_stages: int):
    """(pre, act) per conv of the VGG encoder and its tap indices: the 1x1
    head, reflect 3x3 relu convs, a pool before the last conv of stages 2+
    (``fast_path_q8_std._vgg_q8_layers``'s program)."""
    program, taps = [(None, False), (None, True)], [1]
    for stage in range(2, num_stages + 1):
        specs = _STAGES[stage - 1]
        program += [("pool" if j == len(specs) - 1 else None, True)
                    for j in range(len(specs))]
        taps.append(len(program) - 1)
    return program, taps


def stylize_sanet_spatial(bundle, content_l, style_l, mesh: Mesh,
                          dtype=None) -> torch.Tensor:
    """SANet / AdaptiveSANet serving on this rank's row share (rpst
    ``stylize_sanet_spatial`` :514): the 5-stage VGG encode of both images
    with halo-exchanged reflect convs and row-local pools, the style's
    relu4_1 and relu5_1 gathered whole, the attention modules on the rows
    (``sanet_attention_spatial``), the halo merge conv and the mirror
    decoder with row-local upsamples. Everything in ``dtype``, the
    config's compute_dtype by default, as rpst runs it: in bfloat16 the
    attention is B6's bfloat16 instance (one device's stylize keeps the
    transform in float32). (n, H / spatial, W, 3) rows of content and
    style -> the stylized rows, float32. Every rank of the ``spatial`` axis
    calls it together; ``bundle.vgg`` must be set."""
    from ..dist.collectives import all_gather
    from .fast_path_q8_std import _MIRROR_PROGRAM
    if bundle.network not in SANET_FAMILIES:
        raise ValueError(f"stylize_sanet_spatial serves {SANET_FAMILIES}, "
                         f"not {bundle.network}")
    ax = mesh.axis("spatial")
    check_sanet_height(content_l.shape[1] * ax.size, ax.size)
    if dtype is None:
        dtype = (torch.bfloat16 if bundle.cfg.compute_dtype == "bfloat16"
                 else torch.float32)
    vgg, model = bundle.vgg, bundle.model
    program, tap_idx = _vgg_program(5)
    adaptive = bundle.network == "dynamic_sanet"
    with torch.inference_mode():
        n = content_l.shape[0]
        x = torch.cat([content_l, style_l]).to(dtype)
        taps = []
        for li, (pre, act) in enumerate(program):
            if pre == "pool":
                x = _maxpool2x_any(x)
            c = vgg.conv(li)
            x = reflect_conv_halo_std(x, c.weight.to(dtype),
                                      c.bias.to(dtype), mesh, act)
            if li in tap_idx:
                taps.append(x)
        c4, s4 = taps[3][:n], taps[3][n:]
        c5, s5 = taps[4][:n], taps[4][n:]
        s4, s5 = (torch.cat(all_gather(t, ax), dim=1) for t in (s4, s5))
        tr = model.transform
        kw = {"adaptive": adaptive}
        if adaptive:
            kw["ada_module"] = tr.sanet4_1.ada_module
        a4 = sanet_attention_spatial(tr.sanet4_1, c4, s4, dtype, mesh, **kw)
        a5 = sanet_attention_spatial(tr.sanet5_1, c5, s5, dtype, mesh, **kw)
        merged = a4 + a5.repeat_interleave(2, 1).repeat_interleave(2, 2)
        mc = tr.merge_conv.Conv_0
        x = reflect_conv_halo_std(merged, mc.weight.to(dtype),
                                  mc.bias.to(dtype), mesh, act=False)
        for li, (pre, act) in enumerate(_MIRROR_PROGRAM):
            if pre == "up":
                x = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
            c = getattr(model.decoder, f"conv{li}").Conv_0
            x = reflect_conv_halo_std(x, c.weight.to(dtype),
                                      c.bias.to(dtype), mesh, act)
        return x.float()


# ------------------------------------------------- the standard layout

# the networks whose standard stylize serves on row shares: every one but
# mst (its k-means and chain labelling see whole images, rpst
# serve.py:189-192) and the SANets (their own route above)
STD_SPATIAL_FAMILIES = ("adain", "wct", "mrf", "spade", "seg_adain", "src",
                        "ld_adain", "ld_adain2", "ld_adain3", "ld_adain4",
                        "ld_adain5", "multi_adain", "sel_multi_adain",
                        "ccam")


def check_std_height(h: int, spatial: int) -> None:
    """rpst's one height rule for its GSPMD route (``serve.py:189-190``):
    the rows split evenly over the axis."""
    if h % spatial:
        raise ValueError(f"image height {h} must be a multiple of the "
                         f"spatial axis {spatial}")


# the networks whose standard layout trains on row shares: rpst's 16
# spatial_ok networks (tests/test_train_matrix.py:46-64), every one but mst
STD_SPATIAL_TRAIN = STD_SPATIAL_FAMILIES + SANET_FAMILIES


def loss_std_spatial(bundle, vgg: VGG19Encoder, content_l, style_l,
                     mesh: Mesh, content_label=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, parts) of the one-device standard training loss
    (``bundle.loss(..., folded=False)``: train mode, the config's
    compute_dtype) on this rank's row share, inside ``dist.row_shares``
    and with its batch reductions over ``data`` x ``spatial``
    (``dist.over_batch``): (n, H / spatial, W, 3) content and style rows
    of the rank's batch share (and (n, H / spatial, W) labels for
    seg_adain) -> the GLOBAL loss on every rank (rpst's GSPMD step,
    ``dist/mesh.py:243-248``), differentiable in the model's parameters
    through this rank's rows; the step averages the gradients over the
    batch axes (``dist.average_grads``). sanet's attention is B6b-d on the
    share's query rows against the gathered style (``sanet.whole_style``).
    Every rank of the mesh calls it together."""
    if bundle.network not in STD_SPATIAL_TRAIN:
        raise ValueError(f"loss_std_spatial trains {STD_SPATIAL_TRAIN}, not "
                         f"{bundle.network}")
    ax = mesh.axis("spatial")
    check_std_height(content_l.shape[1] * ax.size, ax.size)
    kw = {} if content_label is None else {"content_label": content_label}
    with row_shares(ax), over_batch(mesh.reduce_axes()):
        total, parts = bundle.loss(vgg, content_l, style_l, folded=False,
                                   **kw)
    plain = lambda t: t.as_subclass(torch.Tensor)  # noqa: E731
    return plain(total), {k: plain(v) for k, v in parts.items()}


def stylize_std_spatial(bundle, content_l, style_l,
                        mesh: Mesh) -> torch.Tensor:
    """The one-device standard stylize (``bundle.stylize(...,
    folded=False)``: eval mode, the config's compute_dtype, the feature
    models' 2N VGG pass) of this rank's row share, inside
    ``dist.row_shares``: (n, H / spatial, W, 3) content and style rows of
    one image batch -> this rank's rows of the stylized batch, or the
    whole batch as a ``dist.Whole`` tensor where the output's rows do not
    split evenly (src's at a height whose VGG pools round up);
    ``dist.whole_rows`` gives the image. Every rank of the ``spatial``
    axis calls it together; ``bundle.vgg`` must be set for src."""
    if bundle.network not in STD_SPATIAL_FAMILIES:
        raise ValueError(f"stylize_std_spatial serves {STD_SPATIAL_FAMILIES}"
                         f", not {bundle.network}")
    ax = mesh.axis("spatial")
    check_std_height(content_l.shape[1] * ax.size, ax.size)
    with row_shares(ax):
        return bundle.stylize(content_l, style_l, folded=False)


__all__ = ["SPATIAL_FAMILIES", "SANET_FAMILIES", "STD_SPATIAL_FAMILIES",
           "STD_SPATIAL_TRAIN", "check_std_height", "loss_std_spatial",
           "stylize_std_spatial", "check_sanet_height",
           "mvn_spatial", "sanet_attention_spatial", "stylize_sanet_spatial", "check_height", "conv_lrelu_halo",
           "folded_adain_spatial", "zero_conv_halo", "channel_pool_spatial",
           "spatial_ops", "stylize_spatial", "reflect_conv_halo_std",
           "vgg_taps_spatial", "tap_stats_spatial",
           "perceptual_rp_losses_spatial", "loss_spatial"]
