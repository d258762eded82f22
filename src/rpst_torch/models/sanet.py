"""The static style-attentional network; port of ``rpst.models.sanet``
(reference ``network/sanet.py``):

  * ``SANetAttention`` (sanet.py:73-99): 1x1 f / g / h convs on
    mean-variance-normalized features, softmax attention over all HWc x HWs
    position pairs, a 1x1 output conv and a residual;
  * ``Transform`` (sanet.py:140-149): the relu4_1 module's output plus the
    upsampled relu5_1 module's, through a 3x3 reflect conv;
  * ``SAModel`` (sanet.py:196-275): transform + VGG-mirror decoder over a
    frozen 5-stage VGG; content (normalized, relu4_1 + relu5_1), style
    statistics (relu1_1 .. relu5_1) and two identity losses.

The attention is B6 (``ops.flash_attention``): on the card the HWc x HWs
matrix (67 MB per image at 512px relu4_1) never exists, in serving or in
training. Features are NHWC, as the VGG returns them: a 1x1 conv is a
linear map of the channel axis, so F, G and H reach B6 as contiguous (N,
HW, C) tensors without a transpose copy. The modules keep ``nn.Conv2d``
parameters under the reference state_dict's names (``sanet4_1.f``, ``.g``,
``.h``, ``.out_conv``, ``merge_conv``), so exported ``.pth`` files load.

The adaptive variant (``dynamic_sanet``, sanet.py:26-71, 100-160, 278-423):

  * ``AEAModule`` / ``AEALReluModule``: a per-query threshold c_p from the
    content-style cosine affinity rows through psi0 ``Linear(HWs, HWs //
    16)``, leaky ReLU and psi1 ``Linear(HWs // 16, 1)``, squashed (sigmoid
    into [0.4, 0.9], or (tanh + 1) / 2). Two routes on the same parameters:
    ``thresholds`` reads dense affinity rows, ``thresholds_factorized``
    applies psi0 through the affinity's factors, c^ (s^T W0^T) + b0, so the
    (HWc, HWs) affinity never exists;
  * ``AdaptiveSANetAttention`` returns (O, aux): the attention re-weighted
    by the thresholds (``ops.adaptive_attention``, dense or streamed by
    query blocks, ``blockwise``), under the reference's names
    (``attention_layer.f_psi.0`` / ``.2``);
  * ``AdaptiveTransform`` and ``SAModel(adaptive=True)``, with
    ``stylize_with_aux`` (the dense route's claim maps).

psi0's width is the style's position count, so the adaptive model serves
one size: (img_size // 8) ** 2 positions at relu4_1 and (img_size // 16) **
2 at relu5_1. The adaptive transform runs in float32 whatever the working
type: rpst's flax modules there take no dtype and promote the bfloat16
features to their float32 parameters. So does the static transform (the
attention on B6's float32 kernel).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.collectives import gather_rows, row_axis
from ..dist.tp import column
from ..nn.blocks import PadConv
from ..nn.decoder import VGGMirrorDecoder, upsample_nearest_2x_nhwc
from ..ops.adaptive_attention import (adaptive_attention_dense,
                                      adaptive_reweighted_attention)
from ..ops.affinity import cal_affinity_matrix, l2_normalize_channels
from ..ops.flash_attention import sanet_attention
from ..ops.stats import mean_variance_norm
from .base import feature_mse, normalized_content_loss, style_stat_loss

Attention = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def conv1x1_nhwc(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv (OI11 weight) of an NHWC tensor as a linear map of its
    channel axis: (N, H, W, C) -> (N, H, W, O), contiguous. One batched
    product, which reads the VGG's features (NHWC views of NCHW tensors)
    through their strides: no transpose copy on either side. A column share
    of the weight (a ``model`` mesh axis) maps onto its output channels,
    gathered after (``dist.tp.column``)."""
    def project(v):
        n, h, w, c = v.shape
        wt = weight.flatten(1).t().to(v.dtype)
        y = torch.baddbmm(bias.to(v.dtype), v.reshape(n, h * w, c),
                          wt.expand(n, -1, -1))
        return y.reshape(n, h, w, -1)
    return column(project, x, weight, -1)


def whole_style(style: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(style for its own statistics, style to mix with the content): on a
    row share (``dist.row_shares``) the style's rows gathered whole
    (``dist.gather_rows``, whose adjoint hands each rank its rows' share
    of dK / dV), as a ``dist.Whole`` tensor and as a plain one (the
    queries' side stays the rank's rows); else ``style`` twice."""
    ax = row_axis()
    if ax is None:
        return style, style
    whole = gather_rows(style, 1, ax)
    return whole, whole.as_subclass(torch.Tensor)


def sanet_attention_block(content, style, f, g, h, out_conv,
                          attention: Attention = sanet_attention):
    """One style-attention module on NHWC features, in float32 whatever the
    working type (an enclosing autocast is left): rpst's flax 1x1 convs take
    no dtype, so they promote bfloat16 features to their float32 parameters.
    ``mean_variance_norm`` runs in the features' own type first, as rpst's
    does, and its output is cast. ``f`` .. ``out_conv`` are float32 (weight,
    bias) pairs of 1x1 convs. Shared by the module and the int8 serving
    path. On a row share the content's rows are the queries and the keys
    and values come from the whole style (``whole_style``)."""
    with torch.autocast(content.device.type, enabled=False):
        n, hc, wc, c = content.shape
        style, _ = whole_style(style)
        plain = lambda t: t.as_subclass(torch.Tensor)  # noqa: E731
        fm = conv1x1_nhwc(mean_variance_norm(content).float(), *f).reshape(
            n, hc * wc, -1)
        gm = conv1x1_nhwc(mean_variance_norm(style).float(), *g).reshape(
            n, style.shape[1] * style.shape[2], -1)
        hm = conv1x1_nhwc(style.float(), *h).reshape(gm.shape)
        o = attention(plain(fm), plain(gm), plain(hm)).reshape(n, hc, wc, -1)
        return conv1x1_nhwc(o, *out_conv) + content.float()


class SANetAttention(nn.Module):
    """A single style-attention module. ``forward(content, style)`` on NHWC
    features of ``in_planes`` channels -> NHWC of the content's shape."""

    def __init__(self, in_planes: int, device=None, dtype=None):
        super().__init__()
        for name in ("f", "g", "h", "out_conv"):
            self.add_module(name, nn.Conv2d(in_planes, in_planes, 1,
                                            device=device, dtype=dtype))

    def pairs(self):
        return [(m.weight, m.bias)
                for m in (self.f, self.g, self.h, self.out_conv)]

    def forward(self, content, style, attention: Attention = sanet_attention):
        return sanet_attention_block(content, style, *self.pairs(),
                                     attention=attention)


class Transform(nn.Module):
    """Merge the relu4_1 and the upsampled relu5_1 attention outputs, in
    float32 whatever the working type, as rpst's (its merge conv, too,
    takes no dtype)."""

    def __init__(self, in_planes: int = 512, device=None, dtype=None):
        super().__init__()
        self.sanet4_1 = SANetAttention(in_planes, device, dtype)
        self.sanet5_1 = SANetAttention(in_planes, device, dtype)
        self.merge_conv = PadConv(in_planes, in_planes, 3, 1, "reflect",
                                  device=device, dtype=dtype)

    def forward(self, c4, s4, c5, s5, attention: Attention = sanet_attention):
        """NHWC relu4_1 / relu5_1 features -> the fused feature, NCHW (the
        decoder's layout)."""
        a4 = self.sanet4_1(c4, s4, attention)
        a5 = self.sanet5_1(c5, s5, attention)
        with torch.autocast(c4.device.type, enabled=False):
            merged = a4 + upsample_nearest_2x_nhwc(a5)
            return self.merge_conv(merged.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# the adaptive SANet (dynamic_sanet)
# ---------------------------------------------------------------------------

Pair = Tuple[torch.Tensor, torch.Tensor]
# AEA_module's constants (sanet.py:26-46): w = sigmoid(SCALE (P - c)), c in
# [FROM, FROM + INTERVAL]
AEA_SCALE, AEA_FROM, AEA_INTERVAL = 50.0, 0.4, 0.5
# config ada_module -> ops.adaptive_attention variant
VARIANT = {"aea": "aea", "relu": "aea_lrelu"}
# config adaptive_blockwise: the attention's route
BLOCKWISE = ("auto", "always", "never")


def _squash(z: torch.Tensor, ada_module: str) -> torch.Tensor:
    if ada_module == "aea":
        return torch.sigmoid(z) * AEA_INTERVAL + AEA_FROM
    return (torch.tanh(z) + 1.0) / 2.0


def aea_thresholds(x: torch.Tensor, psi0: Pair, psi1: Pair,
                   ada_module: str) -> torch.Tensor:
    """Per-query clamp (N, HWc, 1) from dense affinity rows x (N, HWc,
    HWs); psi0 and psi1 are the (weight (out, in), bias) of the two
    Linears."""
    h = F.leaky_relu(F.linear(x, *psi0), 0.2)
    return _squash(F.linear(h, *psi1), ada_module)


def aea_thresholds_factorized(cn: torch.Tensor, sn: torch.Tensor,
                              psi0: Pair, psi1: Pair,
                              ada_module: str) -> torch.Tensor:
    """The same clamp without the (HWc, HWs) affinity: psi0 is linear over a
    row that is itself linear in the style factor (A[p, q] = cn_p . sn_q),
    so psi0(A) = cn @ (sn^T W0^T) + b0. cn (N, HWc, C), sn (N, HWs, C): the
    channel-L2-normalized content and style features. psi0's bias is read
    directly and added once, after the content contraction."""
    w0, b0 = psi0
    m = torch.matmul(sn.transpose(1, 2), w0.t())            # (N, C, K)
    h = F.leaky_relu(torch.matmul(cn, m) + b0, 0.2)
    return _squash(F.linear(h, *psi1), ada_module)


def use_streamed(blockwise: str, device: torch.device, hw_c: int,
                 hw_s: int) -> bool:
    """The adaptive attention's route: ``blockwise`` "always" / "never", or
    "auto": streamed on a CUDA device when both sides have at least
    ``policy.ADAPTIVE_STREAM_ROWS`` positions (rpst's rule, the card in the
    TPU's place), dense otherwise."""
    from ..policy import ADAPTIVE_STREAM_ROWS
    if blockwise != "auto":
        return blockwise == "always"
    return device.type == "cuda" and min(hw_c, hw_s) >= ADAPTIVE_STREAM_ROWS


def adaptive_attention_block(content, style, f: Pair, g: Pair, h: Pair,
                             out_conv: Pair, psi0: Pair, psi1: Pair,
                             ada_module: str = "aea", streamed: bool = False):
    """One adaptive attention module on NHWC features, in float32 (an
    enclosing autocast is left): (O NHWC, aux). ``f`` .. ``out_conv`` are
    the 1x1 convs' (weight, bias), ``psi0`` / ``psi1`` the threshold MLP's;
    all float32. Streamed: the factorized thresholds and the query-blocked
    attention, aux holds ``claim_value`` only; dense: the affinity and the
    (HWc, HWs) attention, aux also holds ``claim_before`` (the softmax) and
    ``claim_after`` (the re-weighted attention). Shared by the module and
    the int8 serving path. On a row share the content's rows are the
    queries against the whole style (``whole_style``): the thresholds are
    per query, so they need no more."""
    with torch.autocast(content.device.type, enabled=False):
        content = content.float()
        style_w, style = (t.float() for t in whole_style(style))
        n, hc, wc, c = content.shape
        hw_s = style.shape[1] * style.shape[2]
        fm = conv1x1_nhwc(mean_variance_norm(content), *f).reshape(
            n, hc * wc, -1)
        gm = conv1x1_nhwc(mean_variance_norm(style_w), *g).reshape(
            n, hw_s, -1).as_subclass(torch.Tensor)
        hm = conv1x1_nhwc(style, *h).reshape(gm.shape)
        variant = VARIANT[ada_module]
        if streamed:
            cn = l2_normalize_channels(content.reshape(n, hc * wc, c))
            sn = l2_normalize_channels(style.reshape(n, hw_s, c))
            clamp = aea_thresholds_factorized(cn, sn, psi0, psi1, ada_module)
            o = adaptive_reweighted_attention(fm, gm, hm, clamp, variant,
                                              AEA_SCALE)
            aux = {"claim_value": clamp}
        else:
            clamp = aea_thresholds(cal_affinity_matrix(content, style), psi0,
                                   psi1, ada_module)
            o, prob, w = adaptive_attention_dense(fm, gm, hm, clamp, variant,
                                                  AEA_SCALE)
            aux = {"claim_value": clamp, "claim_before": prob,
                   "claim_after": w}
        o = conv1x1_nhwc(o.reshape(n, hc, wc, -1), *out_conv) + content
    return o, aux


def check_style_size(dims: Tuple[int, int], s4: torch.Tensor,
                     s5: torch.Tensor) -> None:
    """psi0 reads every style position of its layer: raise unless the
    relu4_1 / relu5_1 style features (NHWC) have ``dims`` positions."""
    got = (s4.shape[1] * s4.shape[2], s5.shape[1] * s5.shape[2])
    if got != tuple(dims):
        raise ValueError(
            f"the adaptive SANet's threshold MLPs read {dims[0]} relu4_1 and "
            f"{dims[1]} relu5_1 style positions ((img_size // 8) ** 2 and "
            f"(img_size // 16) ** 2 of the img_size its weights were built "
            f"for); this style gives {s4.shape[1]}x{s4.shape[2]} = {got[0]} "
            f"and {s5.shape[1]}x{s5.shape[2]} = {got[1]}: serve the model at "
            "the img_size it was built for")


class _AEABase(nn.Module):
    """The psi0 / psi1 threshold MLP (sanet.py:26-71) as the reference's
    ``f_psi`` Sequential: Linear(HWs, HWs // 16), LeakyReLU(0.2),
    Linear(HWs // 16, 1). ``thresholds`` and ``thresholds_factorized`` read
    the same two Linears."""
    ada_module = ""

    def __init__(self, inplanes: int, device=None, dtype=None):
        super().__init__()
        self.f_psi = nn.Sequential(
            nn.Linear(inplanes, inplanes // 16, device=device, dtype=dtype),
            nn.LeakyReLU(0.2),
            nn.Linear(inplanes // 16, 1, device=device, dtype=dtype))

    def pairs(self) -> List[Pair]:
        return [(m.weight, m.bias) for m in (self.f_psi[0], self.f_psi[2])]

    def thresholds(self, x):
        return aea_thresholds(x, *self.pairs(), self.ada_module)

    def thresholds_factorized(self, cn, sn):
        return aea_thresholds_factorized(cn, sn, *self.pairs(),
                                         self.ada_module)


class AEAModule(_AEABase):
    """sigmoid thresholds in [0.4, 0.9], sigmoid re-weighting."""
    ada_module = "aea"


class AEALReluModule(_AEABase):
    """(tanh + 1) / 2 thresholds, softmax(relu(P - c)) re-weighting."""
    ada_module = "relu"


class AdaptiveSANetAttention(nn.Module):
    """SANet + learned attention thresholds (sanet.py:100-138).
    ``forward(content, style, streamed)`` on NHWC features -> (O, aux)."""

    def __init__(self, in_planes: int, spatial_dims: int,
                 ada_module: str = "aea", device=None, dtype=None):
        super().__init__()
        if ada_module not in VARIANT:
            raise ValueError(f"unknown ada_module {ada_module!r}")
        for name in ("f", "g", "h", "out_conv"):
            self.add_module(name, nn.Conv2d(in_planes, in_planes, 1,
                                            device=device, dtype=dtype))
        module = AEAModule if ada_module == "aea" else AEALReluModule
        self.attention_layer = module(spatial_dims, device, dtype)

    @property
    def ada_module(self) -> str:
        return self.attention_layer.ada_module

    def pairs(self) -> List[Pair]:
        """f, g, h, out_conv, psi0, psi1 as (weight, bias)."""
        return [(m.weight, m.bias)
                for m in (self.f, self.g, self.h, self.out_conv)] + \
            self.attention_layer.pairs()

    def forward(self, content, style, streamed: bool = False):
        return adaptive_attention_block(content, style, *self.pairs(),
                                        ada_module=self.ada_module,
                                        streamed=streamed)


class AdaptiveTransform(nn.Module):
    """The adaptive ``Transform`` (sanet.py:150-160), in float32 whatever the
    working type. ``blockwise`` picks the attention's route per call
    (``use_streamed``); ``force_dense`` overrides it (the claim maps)."""

    def __init__(self, in_planes: int = 512, relu4_1_dims: int = 4096,
                 relu5_1_dims: int = 1024, ada_module: str = "aea",
                 blockwise: str = "auto", device=None, dtype=None):
        super().__init__()
        self.sanet4_1 = AdaptiveSANetAttention(in_planes, relu4_1_dims,
                                               ada_module, device, dtype)
        self.sanet5_1 = AdaptiveSANetAttention(in_planes, relu5_1_dims,
                                               ada_module, device, dtype)
        self.merge_conv = PadConv(in_planes, in_planes, 3, 1, "reflect",
                                  device=device, dtype=dtype)
        self.dims = (relu4_1_dims, relu5_1_dims)
        if blockwise not in BLOCKWISE:
            raise ValueError(f"unknown adaptive_blockwise {blockwise!r}")
        self.blockwise = blockwise

    def forward(self, c4, s4, c5, s5, force_dense: bool = False):
        """NHWC relu4_1 / relu5_1 features -> (the fused feature NCHW
        float32, {"relu4_1": aux, "relu5_1": aux}). On a row share the
        style is gathered whole first (``whole_style``)."""
        s4, s5 = (whole_style(t)[0] for t in (s4, s5))
        check_style_size(self.dims, s4, s5)
        outs, aux = [], {}
        for name, c, s in (("relu4_1", c4, s4), ("relu5_1", c5, s5)):
            streamed = not force_dense and use_streamed(
                self.blockwise, c.device, c.shape[1] * c.shape[2],
                s.shape[1] * s.shape[2])
            o, aux[name] = getattr(self, f"sanet{name[4:]}")(c, s, streamed)
            outs.append(o)
        with torch.autocast(c4.device.type, enabled=False):
            merged = outs[0] + upsample_nearest_2x_nhwc(outs[1])
            return self.merge_conv(merged.permute(0, 3, 1, 2)), aux


class SAModel(nn.Module):
    """SANet: trains ``transform`` and ``decoder`` over frozen VGG features;
    ``adaptive=True`` is dynamic_sanet (``AdaptiveTransform`` at
    ``img_size``'s widths). ``attention`` replaces B6's public function in
    the static transform (a benchmark passes the plain version or a library
    call to time them)."""

    def __init__(self, adaptive: bool = False, img_size: int = 512,
                 ada_module: str = "aea", blockwise: str = "auto",
                 device=None, dtype=None):
        super().__init__()
        self.img_size = img_size
        self.adaptive = adaptive
        if adaptive:
            self.transform = AdaptiveTransform(
                512, (img_size // 8) ** 2, (img_size // 16) ** 2, ada_module,
                blockwise, device, dtype)
        else:
            self.transform = Transform(512, device, dtype)
        self.decoder = VGGMirrorDecoder(device, dtype)
        self.attention: Attention = sanet_attention

    def _fuse(self, content_feats, style_feats, force_dense: bool = False):
        args = (content_feats[3], style_feats[3], content_feats[4],
                style_feats[4])
        if self.adaptive:
            return self.transform(*args, force_dense=force_dense)
        return self.transform(*args, self.attention), {}

    def stylize_from_feats(self, content_feats: Sequence[torch.Tensor],
                           style_feats: Sequence[torch.Tensor]):
        """[relu1_1 .. relu5_1] NHWC feature lists -> image (N, H, W, 3)."""
        fusion, _ = self._fuse(content_feats, style_feats)
        return self.decoder(fusion).permute(0, 2, 3, 1)

    def stylize_with_aux(self, content_feats, style_feats
                         ) -> Tuple[torch.Tensor, Dict[str, dict]]:
        """Stylize and return the adaptive modules' claim maps (the reference
        dumps them in test(), sanet.py:334-366): the dense route is forced,
        since the maps are the matrices the streamed route never forms.
        The static model returns no maps."""
        fusion, aux = self._fuse(content_feats, style_feats, force_dense=True)
        return self.decoder(fusion).permute(0, 2, 3, 1), aux

    def forward(self, content_feats, style_feats):
        return self.stylize_from_feats(content_feats, style_feats)

    def loss(self, vgg_features: Callable[[torch.Tensor], List[torch.Tensor]],
             content: torch.Tensor,
             style: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The loss parts (sanet.py:248-275; the adaptive model's are the
        same): the normalized content loss on relu4_1 + relu5_1, style
        statistics over five stages, and the two identity losses; three
        stylize calls and five VGG encodes. The content and style features
        carry no gradient."""
        with torch.no_grad():
            content_feats = vgg_features(content)
            style_feats = vgg_features(style)
        g_t = self.stylize_from_feats(content_feats, style_feats)
        g_t_feats = vgg_features(g_t)
        loss_c = (normalized_content_loss(g_t_feats[3], content_feats[3])
                  + normalized_content_loss(g_t_feats[4], content_feats[4]))
        loss_s = sum(style_stat_loss(g, s)
                     for g, s in zip(g_t_feats, style_feats))
        icc = self.stylize_from_feats(content_feats, content_feats)
        iss = self.stylize_from_feats(style_feats, style_feats)
        l_identity1 = feature_mse(icc, content) + feature_mse(iss, style)
        fcc = vgg_features(icc)
        fss = vgg_features(iss)
        l_identity2 = sum(feature_mse(a, b) + feature_mse(c, d)
                          for a, b, c, d in
                          zip(fcc, content_feats, fss, style_feats))
        return {"content_loss": loss_c, "style_loss": loss_s,
                "l_identity1_loss": l_identity1,
                "l_identity2_loss": l_identity2}
