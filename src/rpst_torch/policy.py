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
  * ``LD2_2N_ENCODE_MIN_BATCH``: from which batch LD v2 encodes content and
    style in one 2N pass rather than two (the same function either way).
  * ``ADAPTIVE_STREAM_ROWS``: from how many positions dynamic_sanet's
    adaptive attention streams under ``adaptive_blockwise: auto``; rpst's
    memory rule, kept because the H100's A/B of the two routes reads level.
"""

from __future__ import annotations

from typing import Dict, Optional

AUTO_MODE = "standard"

# 512px on an H100 80GB HBM3 at 700 W (PERF.md section 6); since B5 and the
# bfloat16 B6 forward run on the tensor cores, standard bfloat16 against q8
# was read in both orders inside one call (bf16, q8, q8, bf16).
# multi_adain (flagship), with B4 on the tensor cores: q8 read 4.89 / 5.08
# ms at b1 against folded bfloat16's 3.04 / 3.03 and standard's 5.60 / 5.72,
# and 23.45 / 23.47 ms at b8 against 18.30 / 18.44 and 40.76 / 40.51 (q8,
# folded, standard, then the reverse, in one call): ahead of standard,
# behind folded bfloat16 at both batches, so no entry (the float glue
# between the int8 layers is ~72% of a b8 q8 stylize, B4 19%).
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
# dynamic_sanet (configs/train_dynamic_sanet.yaml, relu; chip_smoke.py phase
# 33, bf16, q8, q8, bf16): streamed route b1 8.45 / 9.63 ms bfloat16 against
# q8's 10.63 / 8.70, b4 26.74 / 26.65 against 26.95 / 26.69; dense route b1
# 8.24 / 8.10 against 8.61 / 8.40, b4 27.95 / 27.42 against 27.96 / 28.03:
# level or behind (the adaptive attention and the float glue around the
# 16 B5 launches take the rest). A second call (the final chip_smoke.py run)
# read the streamed b1 bf16 12.59 / 13.03 against q8's 11.94 / 10.89 (the
# b1 stylize is host-bound and moves by a third between calls), dense b1
# 9.27 / 8.27 against 10.98 / 11.60, b4 27.07 / 27.11 against 27.06 /
# 27.58 and 27.84 / 28.27 against 28.46 / 28.01: q8 ahead in one call
# only, so no entry.
# src (configs/train_source_adain.yaml, use_mask off; same calls): b1 4.33
# / 4.41 ms bfloat16 against q8's 4.64 / 4.68, b4 14.92 / 15.00 against
# 15.42 / 15.45; second call b1 4.36 / 4.47 against 4.56 / 5.85, b4 15.42 /
# 15.31 against 15.59 / 15.35: q8 behind or level, so no entry; rpst's TPU
# crossover at b4 for both is not copied.
# The flagship's variants (chip_smoke.py phase 38, 512px, bf16: folded,
# standard, q8, folded f32, q8, standard, folded in one call):
# sel_multi_adain b8 q8 21.13 / 21.05 ms against folded bfloat16's 26.83 /
# 27.02 and standard's 43.44 / 43.19: ahead in both orders, so b8 is
# listed; b1 (host-bound) q8 6.19 / 5.37 against folded 6.52 / 4.22: not.
# ccam: q8 8.36 / 9.05 (b1) and 51.05 / 50.87 (b8) against folded 6.39 /
# 7.78 and 40.43 / 40.46; mst: q8 8.79 / 13.56 and 90.74 / 88.34 against
# folded 8.16 / 8.14 and 64.47 / 81.08: behind, so no entry.
# mrf, spade, seg_adain (chip_smoke.py phase 43, 512px, bench.py's widths:
# bf16, q8, q8, bf16 in each of two calls): mrf b1 11.07 / 11.05 and 10.86 /
# 10.53 ms bfloat16 against q8's 16.51 / 16.55 and 16.41 / 16.25, b4 41.3 /
# 40.9 and 41.6 / 41.4 against 62.9 / 62.6 and 62.9 / 62.3; seg_adain (adain's
# path) b1 13.85 / 13.96 and 13.56 / 13.69 against 16.40 / 16.27 and 16.20 /
# 16.23, b4 43.5 / 43.5 and 43.2 / 43.2 against 62.2 / 62.1 and 62.3 / 62.0;
# spade b1 237.9 / 238.3 and 239.1 / 238.2 against 239.4 / 239.7 and 240.9 /
# 240.3, b4 929.1 / 929.4 and 928.9 / 929.3 against 936.6 / 936.5 and 936.4
# / 936.5 (its float32 SPADE generator, rpst's type, is ~99% of every path):
# q8 behind in both orders of both calls, so no entry.
# The LD family (chip_smoke.py phase 48, 512px, the yamls' widths, use_mask
# off; bf16, q8, q8, bf16 in each of three calls): ld_adain (hidden 16) b1
# q8 33.02 / 33.07, 32.86 / 32.87 and 33.03 / 33.00 ms against standard
# bfloat16's 120.97 / 119.91, 119.76 / 119.97 and 119.99 / 119.92 (cuDNN
# picks a slow implicit-GEMM kernel for the bf16 7x7 convs at this batch:
# 79% of the bf16 stylize, profile_torch.py), b4 122.30 / 121.79, 122.65 /
# 121.75 and 122.13 / 121.74 against 128.63 / 128.29, 127.96 / 128.45 and
# 128.24 / 128.27: ahead in both orders of every call at both batches, so
# b1 and b4 are listed. ld_adain2 (hidden 8) b1 21.28 / 21.28
# and 21.47 / 21.51 against 19.27 / 18.91 and 19.24 / 18.27, b4 76.3-76.4
# against 67.7-68.3: behind, no entry. v3-v5 have no int8 path.
# An entry needs q8 ahead in both orders of every call made.
Q8_AUTO_BATCHES: Dict[str, frozenset] = {"sel_multi_adain": frozenset({8}),
                                         "ld_adain": frozenset({1, 4})}

# same card, both on the tensor cores (the same call): the q8 stylize with
# B7 pairs read 26.68 / 26.63 ms at b8 against B4's 23.45 / 23.47; at b1,
# host-bound (59-66% idle), 4.67 / 4.63 against 4.89 / 5.08 in that call
# but 7.25 against 5.10 in another (profile_torch.py). One flag serves every
# batch, and the serving default, b8, loses 13% with pairs. B7 alone is
# 1.6-2.0x two B4 launches on the card (tools/b4_compile_check.py)
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

# dynamic_sanet's adaptive attention under adaptive_blockwise "auto": the
# streamed route (query blocks, factorized thresholds) on a CUDA device when
# both sides have at least this many positions, the dense (HWc, HWs) route
# otherwise. rpst's rule (1024 rows, on the TPU), chosen for memory: the
# dense route holds three (HWc, HWs) float32 matrices per module and image
# (200 MB at 512px relu4_1). Same card, 512px stylize (phase 33, one call),
# streamed against dense: b1 float32 19.31 / 19.44 ms, bfloat16 8.45-9.63
# / 8.10-8.24, b4 float32 442.9 / 420.0 (cuDNN's FFT convs, PERF.md section
# 7), bfloat16 26.65-26.74 / 27.42-27.95: within 5% either way, so the
# memory rule stands
ADAPTIVE_STREAM_ROWS = 1024

# LD v2 (ld_adain2) encodes content and style in one 2N pass of its stack
# from this batch on, in two passes below it (exact either way: no op of
# the stacks couples the batch). rpst's 4 was a TPU v5e reading and is not
# copied. Same card, 512px bfloat16 stylize at the yaml's hidden 8
# (chip_smoke.py phase 48, 2N, two passes, two passes, 2N in each of three
# calls): b1 18.12 / 18.68, 18.47 / 18.14 and 18.68 / 18.34 ms against
# 18.73 / 19.00, 18.57 / 19.90 and 19.37 / 18.61; b2 35.18 / 35.35, 35.46 /
# 35.34 and 35.31 / 35.26 against 35.98 / 36.06, 35.99 / 35.30 and 35.96 /
# 35.41; b4 68.02 / 67.69, 67.59 / 67.71 and 67.96 / 68.34 against 68.62 /
# 68.55, 68.53 / 68.42 and 69.12 / 69.29: the 2N pass ahead by up to 4% or
# level within 0.5%, never behind beyond that: from batch 1 on
LD2_2N_ENCODE_MIN_BATCH = 1
