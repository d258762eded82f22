"""The port's serving and training policy: each choice here is an H100
measurement (PERF.md section 6); none is carried over from ``rpst.policy``,
whose table was measured on a TPU v5e.

  * ``AUTO_MODE``: the path ``--mode auto`` serves where q8 does not win;
    the standard NCHW path led folded B1 at b1 and b8, f32 and bf16.
  * ``Q8_AUTO_BATCHES``: per network, the batches at which the int8 path
    measured fastest of the network's serving paths, so ``auto`` picks q8
    there. A network without an entry never takes q8 under ``auto``.
  * ``FUSE_PAIRS``: whether the flagship's q8 encoder runs consecutive int8
    layers as one B7 launch (``fuse_pairs="auto"``), by the B7-vs-2xB4 A/B.
  * ``TRAIN_Q8_TARGETS_MIN_BATCH``: the smallest batch at which
    ``train_q8_targets`` takes the int8 VGG loss targets (B5).
"""

from __future__ import annotations

from typing import Dict, Optional

AUTO_MODE = "standard"

# 512px on an H100 80GB HBM3 at 700 W (PERF.md section 6).
# multi_adain (flagship): q8 on B4 read 6.6-8.8 ms at b1 against standard's
# 5.6-5.9, and 40.0-40.7 ms at b8 against standard's 40.5-41.2 and folded
# plain bf16's 26.3: fastest at no batch.
# adain (hidden 32): q8 on B5 read 33.5-33.9 ms at b1 and 130.2-130.8 at b4
# against standard bfloat16's 13.7-14.0 and 43.1-43.2 (standard float32
# without TF32: 65.4-65.6 and 268.3-269.4). wct at b1: q8 80.5 ms against
# standard bfloat16's 60.8 (float32 112.3). B5 runs on __dp4a at 5.5% of the
# int8 tensor-core peak, cuDNN's bfloat16 conv on the tensor cores: q8 is
# fastest at no batch, so neither network has an entry.
Q8_AUTO_BATCHES: Dict[str, frozenset] = {}

# same card: B7 pairs 46.2-46.5 ms against B4's 40.0-40.7 at b8; at b1 the
# call is host-bound (17-65% idle) and the two read 6.6-8.8 ms either way
FUSE_PAIRS = False

# same card, the flagship's folded 512px train step, float targets against
# int8 targets on B5, both orders in one call: b1 float32 105.6 / 105.6 ms
# against 88.4 / 89.3, b1 bfloat16 92.7 / 93.7 against 78.9 / 79.3, b4
# float32 365.7 / 365.7 against 303.3 / 303.3, b4 bfloat16 322.1 / 321.6
# against 268.2 / 269.9: 15-17% faster at both batches (six B5 launches
# replace four folded B1 launches and five library convs on the 2N batch),
# so the int8 targets apply from batch 1 on
TRAIN_Q8_TARGETS_MIN_BATCH = 1


def q8_preferred(network: str, batch: Optional[int] = None) -> bool:
    """Did q8 measure fastest for ``network`` at ``batch``? ``None`` asks
    about the serving default, batch 8."""
    return (8 if batch is None else batch) in Q8_AUTO_BATCHES.get(
        network, frozenset())
