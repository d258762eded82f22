"""The port's serving policy: each choice here is an H100 measurement
(PERF.md section 6); none is carried over from ``rpst.policy``, whose
table was measured on a TPU v5e.

  * ``AUTO_MODE``: the path ``--mode auto`` serves where q8 does not win;
    the standard NCHW path led folded B1 at b1 and b8, f32 and bf16.
  * ``Q8_AUTO_BATCHES``: the batches at which the int8 path (B4) measured
    fastest of q8, folded and standard, so ``auto`` picks q8 there.
  * ``FUSE_PAIRS``: whether the q8 encoder runs consecutive int8 layers as
    one B7 launch (``fuse_pairs="auto"``), by the B7-vs-2xB4 A/B.
"""

from __future__ import annotations

from typing import Optional

AUTO_MODE = "standard"

# 512px flagship on an H100 80GB HBM3 at 700 W (PERF.md section 6): q8 on
# B4 read 6.6-8.8 ms at b1 against standard's 5.6-5.9, and 40.0-40.7 ms at
# b8 against standard's 40.5-41.2 and folded plain bf16's 26.3: fastest at
# no batch yet, so ``auto`` never picks it
Q8_AUTO_BATCHES: frozenset = frozenset()

# same card: B7 pairs 46.2-46.5 ms against B4's 40.0-40.7 at b8; at b1 the
# call is host-bound (17-65% idle) and the two read 6.6-8.8 ms either way
FUSE_PAIRS = False


def q8_preferred(batch: Optional[int] = None) -> bool:
    """Did q8 measure fastest at ``batch``? ``None`` asks about the serving
    default, batch 8."""
    return (8 if batch is None else batch) in Q8_AUTO_BATCHES
