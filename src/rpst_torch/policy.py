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

# 512px on an H100 80GB HBM3 at 700 W (PERF.md section 6); since B5 and the
# bfloat16 B6 forward run on the tensor cores, standard bfloat16 against q8
# was read in both orders inside one call (bf16, q8, q8, bf16).
# multi_adain (flagship): q8 on B4 read 6.6-8.8 ms at b1 against standard's
# 5.6-5.9, and 40.0-40.7 ms at b8 against standard's 40.5-41.2 and folded
# plain bf16's 26.3: fastest at no batch.
# adain (hidden 32): q8 on B5 read 16.6 / 16.5 ms at b1 against standard
# bfloat16's 13.4 / 14.1, and 62.4 / 62.5 at b4 against 43.4 / 43.5 (with B5
# on __dp4a it was 33.5-33.9 and 130.2-130.8; standard float32 without TF32:
# 64.9 and 269.9). B5 is now 24% of the q8 stylize and the float glue
# between the int8 layers 63%: no entry.
# wct at b1, three calls: q8 60.9 ms against standard bfloat16's 63.3; q8
# 61.0 / 61.4 against 61.7 / 61.9; q8 60.3 / 60.4 against 59.6 / 59.5
# (float32 111-113; four float32 eigh are ~45 ms of every path): within 4%
# either way, q8 ahead in two calls and behind in the third, so no entry.
# sanet (configs/train_static_sanet.yaml): q8 (16 B5 + 2 B6) read 5.78 / 5.74
# ms at b1 against standard bfloat16's 5.69 / 5.67, and 18.69 / 18.70 at b4
# against 18.71 / 18.58; in another call 5.57 / 5.82 against 5.64 / 5.68 and
# 18.46 / 18.21 against 18.56 / 18.67 (it was 11.5-12.0 and 36.1-36.5 against
# 7.7-11.0 and 23.4-24.4): level within 2%, ahead in one call at b4 only, so
# no entry. rpst's own sanet entry was a TPU's and is not copied.
# An entry needs q8 ahead in both orders of every call made.
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
