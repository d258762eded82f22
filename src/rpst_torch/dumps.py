"""Stylize a test set to image files: what ``test_torch.py`` runs once and
``train_torch.py`` runs every ``test_iter`` steps (rpst's ``test.py`` loop
and ``train.py``'s ``run_test_dump``).

For each batch of ``iter_batches``: the content and style images go to
``ModelBundle.stylize`` with the batch's segmentation masks when the config
sets ``use_mask`` and the set has masks (the photoreal sets'
``labelme_segmentation/``), and each pair is written as
``{content}-{style}-cat.png`` (content, style and stylized side by side)
and ``{content}-{style}.png``. dynamic_sanet's claim maps are written too
where the caller asks (``test_torch.py``, as rpst's ``test.py``), through
``stylize_with_aux`` and ``viz.save_claim_maps``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from .data import iter_batches
from .metrics import logger, save_image, save_image_row
from .ops.segment import label_validity
from .viz import save_claim_maps


def dump_test_set(bundle, dataset, batch_size: int, out_dir,
                  claim_maps_dir=None, iterations: int = 0) -> dict:
    """Stylize ``dataset`` in batches of ``batch_size`` into ``out_dir``;
    dynamic_sanet's claim maps go under ``claim_maps_dir`` when given (file
    ``claim_map/it_{iterations}_bid_{batch}.png``). Returns the counts
    ``{"images", "masked_batches", "valid_labels"}``: the pairs written,
    the batches stylized with masks, and the labels of those batches that
    passed the masked AdaIN's filter at the masks' size."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg, dev = bundle.cfg, bundle.device
    counts = {"images": 0, "masked_batches": 0, "valid_labels": 0}
    for bid, (content, style, c_names, s_names, c_m, s_m) in enumerate(
            iter_batches(dataset, batch_size)):
        c = torch.from_numpy(content).to(dev)
        s = torch.from_numpy(style).to(dev)
        c_labels = s_labels = None
        if cfg.use_mask and c_m is not None:
            c_labels = torch.from_numpy(c_m).to(dev)
            s_labels = torch.from_numpy(s_m).to(dev)
            valid = int(label_validity(c_labels, s_labels,
                                       cfg.max_seg_labels).sum())
            counts["masked_batches"] += 1
            counts["valid_labels"] += valid
            logger.info(f"Batch {bid}: masked AdaIN, {valid} label(s) pass "
                        "the filter at the masks' size")
        if claim_maps_dir is not None and bundle.network == "dynamic_sanet":
            stylized, aux = bundle.stylize_with_aux(c, s)
            save_claim_maps({k: v.float().cpu().numpy()
                             for k, v in aux["relu5_1"].items()},
                            claim_maps_dir, iterations=iterations, bid=bid)
        else:
            stylized = bundle.stylize(c, s, c_labels, s_labels)
        stylized = stylized.cpu().numpy()
        for b, (cn, sn) in enumerate(zip(c_names, s_names)):
            save_image_row([content[b], style[b], stylized[b]],
                           out_dir / f"{cn}-{sn}-cat.png")
            save_image(stylized[b], out_dir / f"{cn}-{sn}.png")
            logger.info(f"Proceed {cn}-{sn}.")
            counts["images"] += 1
    return counts
