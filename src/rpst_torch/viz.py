"""Model-internal visualizations on the host; port of ``rpst.viz``.

The reference dumps diagnostic heatmaps from inside its models:
  * the adaptive SANet's claim maps: threshold / attention before / after
    panels (``network/sanet.py:334-366``), ``save_claim_maps``;
  * per-layer SE channel-attention heatmaps
    (``visualize_channel_attention``, ``network/adain_rp.py:193-213``),
    ``save_channel_attention``;
  * feature-map grids beside a reference image (``visualize_feature_map``,
    ``adain_rp.py:215-228``, and ``make_grid``, ``utils/common.py:5-27``),
    ``make_grid`` and ``save_feature_maps``.

The heatmaps are drawn with matplotlib, as rpst draws them (seaborn's
"rocket" colour map where seaborn is installed, matplotlib's "magma"
otherwise), so the files are rpst's pixel for pixel. A host without
matplotlib (the GPU machine has none) draws the same panels with PIL alone,
in a piecewise-linear magma, under the same file names. The grids are PIL
in both.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw

# matplotlib's magma at 0, 1/8, ..., 1 (8-bit RGB): the PIL route's colours
_MAGMA = np.array([(0, 0, 4), (29, 17, 71), (81, 18, 124), (131, 38, 129),
                   (183, 55, 121), (231, 82, 99), (252, 137, 97),
                   (254, 196, 136), (252, 253, 191)], np.float64)
_PANEL = 256   # the PIL route's panel side, pixels
_TITLE = 16    # and its title band


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _has_seaborn() -> bool:
    try:
        import seaborn  # noqa: F401
        return True
    except ImportError:
        return False


def _render_heatmap(ax, data, vmin=0.0, vmax=1.0, title=None):
    im = ax.imshow(np.asarray(data), vmin=vmin, vmax=vmax, cmap="rocket"
                   if _has_seaborn() else "magma", aspect="auto")
    if title:
        ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    return im


def _heat_panel(data, size, title: str) -> Image.Image:
    """The PIL route: ``data`` in [0, 1] (clipped) coloured by magma,
    resized to ``size`` (w, h) by nearest, under a title band."""
    x = np.clip(np.asarray(data, np.float64), 0.0, 1.0) * (len(_MAGMA) - 1)
    lo = np.minimum(np.floor(x).astype(int), len(_MAGMA) - 2)
    rgb = _MAGMA[lo] + (x - lo)[..., None] * (_MAGMA[lo + 1] - _MAGMA[lo])
    heat = Image.fromarray(np.round(rgb).astype(np.uint8), "RGB").resize(
        size, Image.NEAREST)
    panel = Image.new("RGB", (size[0], size[1] + _TITLE), (255, 255, 255))
    panel.paste(heat, (0, _TITLE))
    ImageDraw.Draw(panel).text((2, 2), title, fill=(0, 0, 0))
    return panel


def _sheet(panels, cols: int) -> Image.Image:
    """Equal-sized panels in rows of ``cols`` on white."""
    w, h = panels[0].size
    rows = -(-len(panels) // cols)
    sheet = Image.new("RGB", (cols * w, rows * h), (255, 255, 255))
    for i, p in enumerate(panels):
        sheet.paste(p, ((i % cols) * w, (i // cols) * h))
    return sheet


def _sheet_path(out_dir, iterations: int, bid: int) -> Path:
    out = Path(out_dir) / "claim_map"
    out.mkdir(parents=True, exist_ok=True)
    return out / f"it_{iterations}_bid_{bid}.png"


def save_claim_maps(aux: dict, out_dir, iterations: int = 0, bid: int = 0,
                    index: int = 0):
    """The adaptive SANet's claim-map sheet (``sanet.py:346-366``) at
    ``<out_dir>/claim_map/it_{iterations}_bid_{bid}.png``. ``aux`` is one
    module's maps (``stylize_with_aux``'s ``'relu5_1'``): claim_value (N,
    HW, 1), claim_before / claim_after (N, HW, HW); the first sample and
    query position ``index`` are drawn."""
    cv = np.asarray(aux["claim_value"])[0, :, 0]
    side = int(np.sqrt(cv.shape[0]))
    before = np.asarray(aux["claim_before"])[0, index].reshape(side, side)
    after = np.asarray(aux["claim_after"])[0, index].reshape(side, side)
    panels = (("Dynamic threshold", cv.reshape(side, side)),
              ("Attention before claim", before),
              ("Attention after claim", after))
    path = _sheet_path(out_dir, iterations, bid)
    plt = _pyplot()
    if plt is None:
        sheet = _sheet([_heat_panel(d, (_PANEL, _PANEL), t)
                        for t, d in panels], 2)
        sheet.save(path)
        return str(path)
    fig, ax = plt.subplots(2, 2, constrained_layout=True)
    for a, (title, data) in zip((ax[0, 0], ax[0, 1], ax[1, 0]), panels):
        _render_heatmap(a, data, title=title)
    ax[1, 1].axis("off")
    fig.savefig(path)
    plt.close(fig)
    return str(path)


def save_channel_attention(attention_maps, out_dir, iterations: int = 0,
                           bid: int = 0):
    """Per-layer SE channel-attention heatmaps (``adain_rp.py:193-213``),
    one row a layer: ``attention_maps`` a list of (N, 1, 1, C) arrays
    (rpst's NHWC; None entries skipped). Returns the path, or None when no
    layer has attention."""
    maps = [np.asarray(m) for m in attention_maps if m is not None]
    if not maps:
        return None
    rows = [(f"Layer {i}", a.reshape(a.shape[0] * a.shape[-1])[None, :])
            for i, a in enumerate(maps)]
    path = _sheet_path(out_dir, iterations, bid)
    plt = _pyplot()
    if plt is None:
        _sheet([_heat_panel(r, (2 * _PANEL, _PANEL // 8), t)
                for t, r in rows], 1).save(path)
        return str(path)
    fig, axes = plt.subplots(len(rows), 1, constrained_layout=True,
                             squeeze=False)
    for idx, (title, row) in enumerate(rows):
        _render_heatmap(axes[idx, 0], row, title=title)
    fig.savefig(path)
    plt.close(fig)
    return str(path)


def make_grid(reference_img: Image.Image, imgs, w_num: int, span: int = 0,
              unit_size: int = 512) -> Image.Image:
    """A sheet of ``imgs`` in rows of ``w_num``, the reference image in a
    leading column (``utils/common.py:5-27``)."""
    h_num = max(1, len(imgs) // w_num)
    w = w_num * (unit_size + span)
    h = h_num * (unit_size + span)
    whole = Image.new("RGB", ((w_num + 1) * (unit_size + span), h),
                      (255, 255, 255))
    whole.paste(reference_img.resize((unit_size, unit_size)), (0, 0))
    x = y = 0
    for img in imgs:
        whole.paste(img.resize((unit_size, unit_size)),
                    (unit_size + span + x, y))
        x += unit_size + span
        if x >= w:
            x = 0
            y += unit_size + span
    return whole


def save_feature_maps(reference_img, feats, out_dir, iterations: int = 0,
                      bid: int = 0, suffix: str = "content",
                      channels: int = 8, unit_size: int = 256):
    """The first ``channels`` feature maps of every layer (NHWC arrays, the
    first sample), each min-max scaled, as a grid beside the reference
    image (``visualize_feature_map``, ``adain_rp.py:215-228``), at
    ``<out_dir>/visualize/it_{iterations}_bid_{bid}_{suffix}.png``."""
    ref = Image.fromarray(
        (np.clip(np.asarray(reference_img), 0, 1) * 255).astype(np.uint8))
    tiles = []
    for feat in feats:
        f = np.asarray(feat)[0]
        for c in range(min(channels, f.shape[-1])):
            fm = f[..., c]
            lo, hi = fm.min(), fm.max()
            fm = (fm - lo) / (hi - lo + 1e-8)
            tiles.append(Image.fromarray((fm * 255).astype(np.uint8), "L")
                         .convert("RGB"))
    sheet = make_grid(ref, tiles, channels, unit_size=unit_size)
    out = Path(out_dir) / "visualize"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"it_{iterations}_bid_{bid}_{suffix}.png"
    sheet.save(path)
    return str(path)
