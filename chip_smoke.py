#!/usr/bin/env python
"""Quickest proof that the PyTorch/CUDA port runs on the GPU: builds the
port's CUDA kernels from this checkout, checks each against its plain
PyTorch version, drives the flagship's folded and int8 serving and training
paths, adain's and wct's serving, and the serving and training of the static
SANet, the adaptive SANet (dynamic_sanet) and SourceNet (src) at 512px
through the user's entry points, the flagship's three variants
(sel_multi_adain, ccam, mst: folded, int8 and training), the flagship's
target cache, mrf, spade and seg_adain (standard and int8 serving,
training) with wct's training and its frozen-encoder resume, and the LD
family (ld_adain .. ld_adain5: standard serving and training, int8 serving
of v1 and v2, v1's 7x7 convs on B5's 7x7 form), adain's training, and the
masked stylize, SE attention and test dumps of slice 7 (the flagship yaml
as written through train_torch.py and test_torch.py), slice 4's remainder
(the deeper yaml as written, SK attention, the Conv2dBlock norms) and
grad_accum / remat on the folded train step, and slice 8a (B2's and
B3's halo modes; two ranks sharing the card over gloo: row-sharded
serving and training of the three folded networks, data-parallel
training, train_torch.py on a spatial mesh), and times them.
Needs one
NVIDIA
Hopper card; run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own line; any failed check raises, exit code != 0):
  1. build     nvcc-build every kernel of the paths, one nvcc per source, all
               at once (B1 folded_conv.cu; B2, B3 folded_conv_bwd.cu; B4
               folded_conv_q8.cu; B7 folded_conv2_q8.cu; B5 conv2d_q8.cu and
               its 7x7 form conv2d_q8_7x7.cu; B6 flash_attention.cu)
  2. kernels   B1, B2, B3 vs their plain versions at the paths' shapes, f32 +
               bf16, B1 and B2 with folded (36 of 144 blocks non-zero) and
               dense kernels; B1 and B2 timed at (1,256,256,128->128) and
               (1,128,128,512->512), both types and both kernel kinds,
               beside plain, the library call on the folded layout
               (F.conv2d on the ring-padded tensor; conv2d_input), the
               unfolded conv the standard path runs (reflect pad + F.conv2d
               on (N, C, 2H, 2W); conv2d_input) and the dense and
               structured bounds; B3 dense and listed (the fold's 36
               blocks) at every case, each bit-equal across two runs, the
               listed one's unfolded-kernel gradient equal to the dense
               one's, and timed in both modes beside plain, conv2d_weight
               on the ring-padded folded tensor and on the reflect-padded
               unfolded image, and the dense and structured bounds
  3. fixture   folded stylize on the card vs rpst's JAX output
               (tests/fixtures/torch_port_flagship.npz)
  4. parity    512px: folded (B1) vs the port's standard path; bf16 vs f32;
               launches == folded conv layers run
  5. serve     the serving main path: 8 requests through build_model ->
               resolve_mode -> make_run_impl -> DynamicBatcher, launch
               counts reset before and read after; then serve_torch.py's
               folder sweep as a subprocess
  6. daemon    serve_torch.py --daemon: 6 requests + stats + shutdown
  7. timing    512px stylize b1/b8, f32/bf16: folded B1 and standard in
               both orders (folded, standard, folded plain, standard,
               folded), with CUDA events, 5 calls each (the later timing
               phases: 3 calls after 1 warm-up, phases 39-43's 5 after 2)
  8. train fixture  the folded train step on the card (B1/B2/B3) vs rpst's
               JAX loss, gradients and 3-step trajectory
               (tests/fixtures/torch_port_train.npz)
  9. train parity   512px b2 f32: loss and gradients of the kernel path vs
               the plain path (autograd through B1's plain version) and vs
               exec_strategy standard; bf16 vs f32 gradient cosines
 10. train     the training main path: train_torch.py on a synthetic 512px
               corpus (b4, f32, folded), 3 steps as a subprocess, then a
               resume for 2 more in this process with the counts reset
               before and read after; exact B1/B2/B3 launches per step
 11. train timing  the 512px train step, b1/b4, f32/bf16: folded with the
               B-kernels, folded plain, standard, with CUDA events
 12. q8 kernels    B4 vs its plain version at the path's shape (1,256,256,
               128->128), a ragged one and the tilings' edges (N = 3; W =
               33, 37; H = 2; 4C = 16; 4Co = 4, 132), each with a quantized
               fold (36 listed blocks) and a dense kernel, all four
               (out_int8, with_stats) modes: int8 identical, bf16 within one
               ulp, s1/s2 within rtol 1e-4 / atol 1e-3; B7's six outputs
               (float32 sums included) equal to two B4 launches; each timed
               against its plain version, folded and dense, beside B1 bf16
               at the same shape
 13. q8 fixture    the q8 stylize on the card with rpst's act scales vs
               rpst's JAX output (tests/fixtures/torch_port_q8.npz), f32 and
               bf16, exact B1/B4 (and B1/B4/B7 with fuse_pairs) launches
 14. q8 parity     512px b2: q8 vs the port's folded f32 path (PSNR > 30
               dB); fuse_pairs bit-equal to unfused
 15. q8 serve      the int8 main path: 8 requests through build_model ->
               resolve_mode("q8") -> calibrate_scales -> make_run_impl ->
               DynamicBatcher, counts reset before and read after, once
               unfused (B1 + B4) and once with fuse_pairs (B1 + B4 + B7);
               then serve_torch.py --mode q8 as a subprocess
 16. q8 timing     512px stylize b1/b8 in bfloat16: q8 with B4, q8 with B7
               pairs, folded B1 and standard (one order, for the script's time
               limit), beside phase 7's rows

 17. B5 kernels    B5 vs its plain version (float64 conv: exact integer
               sums) at every shape the adain / wct stylize and the int8 VGG
               targets give it (the 512px ones at 2N = 2), int8 and bf16 out:
               int8 identical, bf16 within one ulp compared numerically (the
               -0.0 of alpha = 0 equals +0.0; the bits are compared too and
               reported); alpha {0, 0.2, 1} x pad {reflect, zero} x out at an
               odd shape, and both pads x both outputs at the edges of the
               tensor-core tilings (C = 4, 36, 48; Co = 4, 132; H or W = 2;
               W = 33, 37); the bf16 mode vs plain (2e-2); each path shape
               timed (weights packed once, as the paths keep them) against
               plain and against F.conv2d in bfloat16 on the dequantized
               values
 18. wide fixtures  adain and wct on the card vs rpst's JAX output
               (tests/fixtures/torch_port_{adain,wct}.npz, 64px, hidden 32):
               standard f32, and q8 with rpst's scales (float32: PSNR >= 40
               dB, MAE < 2e-3; bfloat16: PSNR >= 30 dB, MAE < 1e-2), exact
               B5 launches
 19. q8 targets fixture  vgg_target_taps_q8 and
               perceptual_rp_losses_q8targets on the card vs rpst's JAX
               (tests/fixtures/torch_port_q8_targets.npz, 64px b4): the
               int8 taps PSNR >= 40 dB, loss parts rtol 5e-3, 6 B5 launches
 20. wide serve    the adain / wct main path: 8 requests through build_model
               -> resolve_mode("q8") -> calibrate_scales -> make_run_impl ->
               DynamicBatcher(b4) at hidden 32, counts reset before and read
               after (4 B5 per stylize); serve_torch.py --mode q8 as a
               subprocess for adain (hidden 32, and the repository's
               configs/train_deeper_rp_adain.yaml at hidden 16: 2 B5 per
               stylize) and for wct
 21. q8-targets train  train_torch.py, flagship, train_q8_targets=true, b4
               f32 folded, 3 steps in this process, counts reset before and
               read after: exact B1/B2/B3/B5 launches per step
 22. wide timing   512px: adain b1/b4 standard f32/bf16 vs q8, wct b1; the
               flagship train step b1/b4 with and without int8 targets (one
               order each, for the script's time limit)

 23. B6 kernels    B6a-d (forward, forward + LSE, dQ, dK/dV) vs their plain
               versions at the shapes of a 512px SANet stylize, relu4_1 (N,
               4096, 4096, 512) and relu5_1 (N, 1024, 1024, 512) at N = 1
               and 4, f32 (1e-4) and bf16 (2e-2), LSE 1e-4, a ragged
               rectangular case and inputs x 30; both forwards' O also
               against its own size at x 1 (f32 1e-5 of max |ref|, mean
               1e-6; bf16 2e-2, 2e-3), and the f32 forward's O at x 30
               against a float64 oracle (at most 3x the plain version's
               error, or 3 x 2^-20 of max |O| where that is more:
               rpst_torch.ops.flash_attention.f32_oracle_limit); the f32
               dQ, dK, dV at x 1 also within 1e-5 (mean 1e-6) of max |ref|
               from the float64 oracle of their own function
               (attention_grads_f64 of the same LSE and Delta), at x 30
               against it in place of plain (f32_oracle_limit); the
               bf16 dQ, dK, dV within 2e-2 (mean 2e-3) of max |plain|
               (rpst_torch.ops.flash_attention.check_backward); each
               forward (a tensor-core kernel per type) also
               around its tiles, bf16 32 x 64 at C = 128, 256, 384, f32
               32 x 32 at C = 128-512, N = 3; the backward in both types
               around its 16 x 32 tiles at C = 128-512, N = 3; dQ, dK, dV
               bit-equal across two runs; each timed against plain and
               against
               F.scaled_dot_product_attention(scale=1.0) and its autograd
               backward; B5 at the SANet path's six new shapes is in phase 17
 24. sanet fixture  the static SANet on the card vs rpst's JAX output
               (tests/fixtures/torch_port_sanet.npz, 64px b2): standard f32
               (1e-4), q8 with rpst's scales (f32 PSNR >= 35 dB, bf16 >= 30),
               loss parts (rtol 1e-4) and gradients (rtol 5e-3, atol 1e-4 x
               max), exact B5 / B6 launches
 25. sanet parity   512px b2: the model on B6 vs the same model on the plain
               attention, f32 and bf16
 26. sanet serve    the SANet main path: 8 requests through build_model ->
               build_vgg -> resolve_mode -> [calibrate_scales ->] make_run_impl
               -> DynamicBatcher(b4), standard and q8, counts reset before and
               read after (2 B6 per stylize; q8 16 B5 + 2 B6); serve_torch.py
               --mode standard and --mode q8 as subprocesses
 27. sanet train    train_torch.py on configs/train_static_sanet.yaml's
               settings (512px, batch 4, f32): 3 steps in this process, then a
               resume for 2 more in this process with the counts reset before
               and read after: exact 6 / 6 / 6 B6 fwd / dQ / dK/dV per step;
               then 2 steps in bfloat16 the same way (the forward is then the
               tensor-core kernel)
 28. sanet timing   512px stylize b1 / b4 standard f32, bf16 and q8, each
               with B6, with the plain attention and with the SDPA call in
               B6's place (in this script only), and the train step b1 / b4
               f32 and bf16 with B6 (its plain / SDPA steps cut for time)

 29. 6b fixtures  dynamic_sanet and src on the card vs rpst's JAX output
               (tests/fixtures/torch_port_{dynamic_sanet,src}.npz, 64px b2):
               dynamic_sanet f32 on the dense and the streamed route (1e-4),
               src f32 (1e-4), q8 with rpst's scales (f32 PSNR >= 35 dB,
               bf16 >= 30), loss parts (rtol 1e-4) and gradients, exact B5
               launches (16 / 12 per q8 stylize) and no B6; the adaptive
               attention's streamed O against its dense form at (1, 4096,
               4096, 512) f32, both variants, 1e-5 of max |O|
 30. 6b serve      8 requests per network through build_model -> build_vgg
               -> resolve_mode -> [calibrate_scales ->] make_run_impl ->
               DynamicBatcher(b4), standard and q8, 512px, counts reset
               before and read after (q8: 16 / 12 B5 per batch, 0 B6); then
               serve_torch.py --mode q8 as a subprocess for each network
 31. 6b train      train_torch.py on configs/train_dynamic_sanet.yaml's
               settings (512px, b1, relu, f32; the streamed route under
               autograd) and configs/train_source_adain.yaml's (512px, b8):
               3 steps in this process, then a resume for 2 more in this
               process, counts reset before and read after (no kernel),
               the resumed run's peak device memory printed
 32. 6b parity     512px b2: dynamic_sanet streamed vs dense, f32 (1e-3) and
               bf16 (2e-2 x span); q8 vs f32 for both networks (> 30 dB)
 33. 6b timing     512px stylize b1 / b4: dynamic_sanet streamed and dense,
               standard f32, bf16 and q8, src f32, bf16 and q8 (one order,
               for the script's time limit); each network's train
               step at its config's batch (b1, b8), f32

 34. slice-4 fixture  sel_multi_adain, ccam and mst on the card vs rpst's JAX
               (tests/fixtures/torch_port_{sel_multi_adain,ccam,mst}.npz,
               64px b2, full width): folded f32 and standard (1e-4), folded
               bf16 (MAE < 1e-2 or 3 x rpst's own bf16 distance), q8 with
               rpst's scales (f32 >= 35 dB, bf16 >= 30), loss parts (rtol
               1e-4), gradients (rtol 5e-3, atol 1e-4 x max or 4 x the
               tensor's own float32 error in rpst; the folded and standard
               paths' distances to rpst's float64 gradients printed); the
               standard path (cuDNN) held as phases 39 / 45 hold theirs:
               float64 against rpst's float64 with float64 statistics
               (grads_f64s, 1e-4 x max), float32 against rpst's standard
               float32 at 4 x the larger own float32 error, the worst
               tensor's errors and its layer's cuDNN kernels by name,
               sel's moved BatchNorm statistics,
               mst's k-means labels; exact launches (15 B1 a stylize, 3 B1 +
               12 B4 a q8 stylize, 23/17/15 B1/B2/B3 a loss + backward, mst
               23/8/5); the target cache's cached flagship step vs rpst's
               pretargets loss and gradients (19/17/15) and the recomputed
               step (tests/fixtures/torch_port_target_cache.npz)
 35. slice-4 parity   512px b2: each folded variant vs its standard module
               (1e-4), bf16 vs f32 (MAE < 2e-2), q8 vs folded f32 (> 30 dB);
               mst's style-channel label flips folded vs standard and bf16
               vs f32, its fused features on the channels whose cluster
               agrees, its output when no label flips
 36. slice-4 serve    sel_multi_adain's main path, 8 requests through
               build_model -> resolve_mode -> [calibrate_scales ->]
               make_run_impl -> DynamicBatcher(b4), folded and q8, counts
               reset before and read after (15 B1; 3 B1 + 12 B4 a batch;
               calibration 15 B1); serve_torch.py --mode folded and q8 for
               each variant (ccam's and mst's yamls with shuffle=false); the
               daemon on ccam
 37. slice-4 train    train_torch.py for each variant at 512px folded
               (sel_multi_adain b4 f32, ccam and mst their yamls' b2 bf16):
               3 steps in this process, a resume for 2 in this process with
               exact B1/B2/B3 launches; sel's BatchNorm statistics kept over
               a forced non-finite step; the flagship b4 with target_cache
               512 on an 8-image corpus: the hits and misses of stats()
               against the loaders' key streams, 23/17/15 a miss and 19/17/15
               a hit
 38. slice-4 timing   512px stylize b1 / b8 of each variant (folded bf16,
               standard bf16, q8, folded f32); the train step at each
               variant's settings; the flagship's b1 / b4 step, f32 and
               bf16, with float targets, int8 targets and the cache hitting
               (one order each, for the script's time limit)

 39. 5b fixtures  mrf, spade, seg_adain and wct training on the card vs
               rpst's JAX (tests/fixtures/torch_port_{mrf,spade,seg_adain,
               wct_train}.npz, 64px b2, hidden 32): stylize f32 (1e-4) and
               bf16 (MAE < 1e-2 or 3 x rpst's own bf16 distance), q8 with
               rpst's scales (f32 >= 35 dB, bf16 >= 30) with exact B5
               launches (7 / 4 / 4), calibration within 2e-2 of rpst's,
               loss parts (rtol 1e-4), gradients in float32 and float64
               (tests/test_torch_mrf.py's rule, 4 x the frameworks' own
               float32 errors on the card), the 3-step trajectory (seg_adain
               with labels, wct with the encoder frozen and bit-unchanged)
 40. 5b parity    512px b2 at bench.py's widths: q8 vs f32 (> 30 dB) and
               bf16 vs f32 (MAE < 2e-2) for the three networks; the MRF
               loss streamed (chunk 1024) vs its dense threshold form at
               relu4_1 (4096 positions), the dense top-k route beside it;
               B5 at the mrf decoder head's (1,512,512,1024->512) vs plain
               (int8 identical, bf16 bits equal)
 41. 5b serve     each network's main path: 8 requests through build_model
               -> resolve_mode -> [calibrate_scales ->] make_run_impl ->
               DynamicBatcher(b4), standard and q8, counts reset before and
               read after (q8: 7 / 4 / 4 B5 a batch, no other kernel);
               serve_torch.py --mode q8 as a subprocess for each, and for
               spade at configs/TrainConfig.yaml (hidden 2: 0 scales, 0 B5)
 42. 5b train     train_torch.py at 512px: mrf, spade, seg_adain b1 at
               bench.py's widths, seg_adain on a synthetic side-by-side
               seg_dir, spade at configs/TrainConfig.yaml, wct at
               configs/train_deeper_rp_wct.yaml (b4) with resume: true
               (the encoder frozen): 3 steps in this process, a resume for 2
               in this process (no kernel launched), the resumed run's peak
               memory, the frozen encoder's bytes unchanged; a wct
               checkpoint saved without the freeze refused on resume
 43. 5b timing    512px stylize b1 / b4 of the three networks: f32, then
               bf16 and q8 (one order: time); the train step b1 of the
               three and of wct, f32, with its peak memory

 44. B5 7x7     B5's 7x7 form (wgmma, conv2d_q8_7x7.cu) vs its plain
               version at LD v1's two 512px shapes, (2,512,512,128->128) and
               (256->256) (and at N = 8, int8 out), and around its tiles (H, W
               = 4, 5, 16, 17, 19, 21, 33; C = 4, 32, 36, 2048; Co = 4, 68,
               128, 132, 136, 200, 260; N = 8), int8 and bf16 out, alpha 0.2
               and 0: bit-equal to plain and across two runs; its occupancy
               from ptxas; the bytes its tiling stages from L2; each path
               shape timed raw, through the wrapper, beside plain (N = 2),
               F.conv2d bf16 7x7 and the bound of its int8 operations
 45. LD fixtures  the five LD networks on the card vs rpst's JAX
               (tests/fixtures/torch_port_ld_adain*.npz, 32px b2, the
               yamls' widths): stylize f32 (1e-4) and bf16 (MAE < 1e-2 or 3
               x rpst's own), v1 / v2 q8 with rpst's scales (f32 >= 35 dB,
               bf16 >= 30) with exact launches (6 B5, two 7x7; 4 B5), the
               first eligible layer's int8 features on rpst's int8 input
               (one step on under 1e-3), loss parts, gradients (float32,
               and float64 with the feature statistics in float64), the
               3-step trajectory
 46. LD serve     each network's main path at 512px: 4 requests through
               build_model -> resolve_mode -> [calibrate_scales ->]
               make_run_impl -> DynamicBatcher(b2), standard for the five,
               q8 for v1 / v2, counts reset before and read after;
               serve_torch.py on each yaml at b1 (v1 / v2 --mode q8, v1
               with use_mask=false; v3-v5 --mode folded, served standard)
 47. LD train     train_torch.py on each LD yaml's settings at 512px: 3
               steps and a resume for 2, in this process, no kernel
               launched, the resumed run's peak memory
 48. LD timing    512px stylize b1 / b4: v1 / v2 standard bf16 and q8
               (one order: time), v3-v5 bf16; v2's 2N encode against two
               passes at b1, b2, b4 in both orders; each yaml's train step

 49. adain train  adain's training vs rpst's JAX
               (tests/fixtures/torch_port_adain_train.npz: the widths of
               configs/train_deeper_rp_adain.yaml, 64px b2): loss parts,
               float32 and float64 gradients by the slice-5b rule, the
               3-step trajectory, no kernel launched; the yaml's 512px b8
               train step timed in float32 and bfloat16 with its peak memory

 50. masks fixture  the masked stylize on the card vs rpst's JAX
               (tests/fixtures/torch_port_masks.npz, 64px b2, seeded label
               maps holding the filter's four cases): the flagship yaml's
               multi_adain at full width (attention se, use_mask; and with
               sort), ccam, sel_multi_adain, src, seg_adain and LD v1, f32
               (1e-4) and bf16 (MAE < 1e-2 or 3 x rpst's own bf16
               distance), no B1 and no B4 launched (rpst's gates); the SE
               flagship's train-mode loss parts, float32 gradients (4 x
               each tensor's own float32 error in rpst) and moved
               BatchNorm statistics
 51. flagship yaml  configs/train_constant_multiscale_rp_adain.yaml as
               written (512px b8 bf16, attention se, use_mask) through
               train_torch.py as a subprocess, only data paths, VGG,
               output and cadence overridden: 3 steps, a test dump of a
               synthetic photoreal set (tools/make_photoreal_set.py) in
               which a masked AdaIN ran; test_torch.py on the checkpoint
               writes the same files, its PNGs the masked stylize's
 52. masks timing  the yaml's model at 512px b1 / b8, bf16 and f32:
               masked stylize vs the same model without labels in both
               orders, with peak memory; the masked AdaIN op alone; the
               yaml's b8 bf16 train step (img/s, peak memory)
 53. test_torch    test_torch.py on the recon yaml (exec_strategy folded:
               15 B1 launches for its one batch) and on
               configs/train_dynamic_sanet.yaml (claim-map sheets written)
 54. slice4r fixture  slice 4's remainder vs rpst's JAX
               (tests/fixtures/torch_port_slice4r.npz, 64px b2): the
               deeper yaml's model (deeper stacks, inception 3, use_mask:
               masked stylize), multi_adain with SK attention, the SE
               flagship under grad_accum 2 (rpst's _accumulate_grads), in
               f32 and bf16, float32 / float64 gradients by the slice-5b
               rule, running statistics; Conv2dBlocks with bn / in and
               prelu; no B1 and no B4 launched
 55. deeper yaml  configs/train_deeper_multiscale_rp_adain.yaml as written
               (512px b1) through train_torch.py: 3 steps, a masked test
               dump, test_torch.py on the checkpoint; its step timed in
               f32 and bf16 with peak memory
 56. accum/remat  the folded flagship step at 512px b8, bf16 and f32, with
               grad_accum 1 / 2 / 4 and remat off / on: exact B1 / B2 / B3
               launches, gradients held to grad_accum 1, time and peak
               memory; the SE model's remat step vs its plain step (the
               running statistics moved once); spade's b4 f32 step under
               grad_accum 4

 57. halo       B2 with row_rings=False and B3 with given rings (listed and
               dense, bit-equal across two runs), and FoldedConvActHalo's
               backward, vs their plain versions at one 512px row share's
               lane-filling shape (1,128,256,128->128), folded and dense
               kernels, f32 (1e-4) and bf16 (2e-2); each timed beside its
               one-device mode, plain and the library call
 58. spatial    two ranks on the one card over gloo (chip_smoke.py
               --spatial-rank): the three folded networks at 64px on
               {spatial: 2} vs rpst's row-sharded functions
               (tests/fixtures/torch_port_spatial.npz: stylize, loss parts,
               gradients by the float32 rule); the flagship at 512px b2:
               stylize and train steps on {spatial: 2} and {data: 2} vs the
               one-device folded path (loss, gradients, the Adam step),
               sel_multi_adain (running statistics) and ccam steps on
               {spatial: 2}; launches of B2 row_rings=False and B3 rings
 59. spatial train  train_torch.py on the flagship yaml (attention none,
               use_mask false, folded) with mesh_shape {spatial: 2}: the
               driver starts its 2 ranks, 3 steps at 512px b8 bf16, one
               checkpoint and the loss lines from rank 0

 60-61. slice 8b  two ranks on the one card (chip_smoke.py --slice8b-rank):
               sanet / dynamic_sanet on {spatial: 2} vs rpst's
               stylize_sanet_spatial (tests/fixtures/torch_port_slice8b.npz)
               and at 512px vs one device; the flagship's and a sanet step
               on {model: 2} vs one device, the checkpoint served
 62. daemon     serve_torch.py --daemon --mesh 2: 4 requests over TCP, the
               PNGs vs the one-device stylize, a shutdown every rank obeys
 63. slice 8c   two ranks on the one card (chip_smoke.py --slice8c-rank):
               the standard layout of adain, wct, mrf, spade, seg_adain,
               src and LD v1-v5 on {spatial: 2} through the serving run
               function: at rpst's test size vs
               tests/fixtures/torch_port_slice8c.npz (uint8 within one
               step of rpst's one device and GSPMD, float32 1e-4), at 512px
               b1 vs the one-device stylize (f32 1e-4; adain and LD v1 in
               bf16 too), each timed beside one device; no kernel launched
 64. slice 8c train  phase 63's two ranks on the one card, after
               phase 63's serving: the standard layout trained on
               {spatial: 2} (train.step's rows route): rpst's 16 spatial_ok
               networks at its _TINY vs
               tests/fixtures/torch_port_slice8c_train.npz (SGD(1.0), rpst's
               limits or 1e-3 of the largest update, ranks bit-equal); sanet
               (train_static_sanet.yaml, 512px b1, f32 and bf16) with
               exactly 6 / 6 / 6 B6b-d a rank, the flagship's standard
               layout (512px b2) and the 15 others at 256px b2 vs one
               device's step; B6b-d at one row share (1, 2048, 4096, 512)
               beside the whole image's, f32 and bf16, vs plain, timed with
               SDPA and the bound; train_torch.py on {spatial: 2, model: 2}
               (4 ranks, 2 steps of the flagship yaml's standard layout at
               256px)

The last lines: the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}. Without a CUDA device, or away from the
repository, it exits non-zero and prints no result.
"""

import copy
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FLAGSHIP = dict(network="multi_adain", enc_stack_way="constant", rp_blocks=5,
                hidden_dim=32, inception_num=0, attention="none", seed=0)
IMG = 512
F32_TOL = 1e-4   # rtol = atol: K = 9*128 products summed in another order
BF16_TOL = 2e-2  # rtol = atol: about two bf16 ulps at O(1) values
# the bfloat16 attention forward's O is an average over Nk keys, far below
# O(1) (max |O| ~0.03 at Nk = 4096), so BF16_TOL alone would pass half of O
# or a dropped V tile: O is also held to the data's own size, max abs err <=
# 2e-2 x max |ref| (a few bf16 ulps of the largest value) and mean abs err
# <= 2e-3 x max |ref| (a half-ulp rounding of typical values is ~3e-4)
BF16_O_REL, BF16_O_MEAN_REL = 2e-2, 2e-3
# B3's dk/db: rtol 1e-4 and an atol that grows with the summed length L =
# N*H*W as f32 rounding of a sum of L O(1) products does: 2e-3 at L = 512,
# the bound of tests/test_folded.py:406-411 at 16x16, batch 2
DK_ATOL_512 = 2e-3
# train parity (tests/test_folded.py:133-138): loss rtol 1e-4; gradients
# rtol 5e-3 with atol 1e-4 x the tensor's max; bf16 vs f32 gradients by
# cosine, the gate of tests/test_q8_targets.py:100
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_REL, BF16_COS = 1e-4, 5e-3, 1e-4, 0.98
# B1 / B2 / B3 launches of one folded flagship train step with separate
# encodes: B1 runs 15 RP layers (5 per encode of content and style, 5
# decoder) + 4 folded VGG layers on the stylized image + 4 on the 2N
# style/content targets = 23; B2 runs on every layer whose input needs a
# gradient: 13 RP (not the two first encoder layers, whose input is an
# image) + the 4 VGG layers of the stylized pass = 17; B3 on the 15 RP
# layers and never on the frozen VGG = 15
PER_STEP = (23, 17, 15)
# with train_q8_targets the 2N style/content target pass leaves the folded
# VGG (4 B1 launches fewer) for the int8 chain: 6 B5 launches (conv_4 ..
# conv_9 of the encoder); B2 and B3 never ran on the targets
PER_STEP_Q8T = (PER_STEP[0] - 4, PER_STEP[1], PER_STEP[2])
B5_PER_TARGET_PASS = 6
# published dense peaks of one H100 SXM (operations per second by operand
# type; float32 data is held to the TF32 tensor-core rate) and its memory
# rate, for the kernels line's bound_ms
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 495e12}
HBM_BYTES_PER_S = 3.35e12


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check_close(name, got, ref, tol, mae_max=None):
    """Raise unless |got - ref| <= tol + tol*|ref| everywhere (and the mean
    abs error is below mae_max); return the max abs error."""
    import torch
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite output")
    err = (got - ref).abs()
    max_err, mae = err.max().item(), err.mean().item()
    if not torch.allclose(got, ref, rtol=tol, atol=tol):
        raise AssertionError(f"{name}: max abs err {max_err} > tol {tol}")
    if mae_max is not None and not mae < mae_max:
        raise AssertionError(f"{name}: MAE {mae} >= {mae_max}")
    return max_err, mae


def check_scaled(name, got, ref, rel, mean_rel):
    """Raise unless max |got - ref| <= rel * max |ref| and mean |got - ref|
    <= mean_rel * max |ref|; return (max abs err, mean abs err) / max |ref|."""
    got, ref = got.float(), ref.float()
    err, size = (got - ref).abs(), ref.abs().max().item()
    max_err, mae = err.max().item(), err.mean().item()
    if not (max_err <= rel * size and mae <= mean_rel * size):
        raise AssertionError(
            f"{name}: max abs err {max_err}, mean {mae} against max |ref| "
            f"{size} (limits {rel} and {mean_rel} of it)")
    return max_err / size, mae / size


def check_oracle(name, got, ref64, limit):
    """Raise unless max |got - ref64| <= limit, ref64 a float64 oracle;
    return that max abs err."""
    import torch
    if got.shape != ref64.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref64.shape)} or non-finite output")
    err = (got.double() - ref64).abs().max().item()
    if not err <= limit:
        raise AssertionError(f"{name}: max abs err from the float64 oracle "
                             f"{err} > {limit}")
    return err


def cuda_ms(fn, iters=20, warmup=3):
    """Median ms of ``fn()`` over ``iters`` runs, each timed with CUDA
    events after ``warmup`` untimed runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(ops, nbytes, kind):
    """(least ms the card could take, which limit binds): the larger of
    ``ops`` over the peak rate of ``kind`` and ``nbytes`` (each input read
    once, each output written once) over the memory rate."""
    t_ops = ops / PEAK_OPS[kind] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def conv_bound(n, h, w, c, co, kind, in_size, out_sizes, extra_bytes=0,
               layers=1):
    """bound_ms of a 3x3 conv layer (or ``layers`` chained ones of one
    width): 2 * 9 * C * Co operations per output pixel; the input, the
    weights (of the input's type), the per-channel rows and every output
    moved once. Sizes are bytes per element."""
    px = n * h * w
    ops = layers * 2 * 9 * px * c * co
    nbytes = (px * c * in_size + layers * 9 * c * co * in_size
              + sum(px * co * sz for sz in out_sizes) + extra_bytes)
    return bound_ms(ops, nbytes, kind)


def q8_bound(n, h, w, c4, c4o, structured, out_size=1, layers=1):
    """bound_ms of B4 (``layers`` 1) or B7 (2: 4C -> 4Co -> 4Co) at (N, Hf,
    Wf): the listed blocks' operations (the 36 of a folded kernel, the
    unfolded conv's; all 144 of a dense one) at the int8 peak; x, each
    layer's int8 output (the last one ``out_size`` bytes an element), the
    kernels, the per-channel rows and the sums moved once."""
    px = n * h * w
    ops = layers * 2 * 9 * px * c4 * c4o // (4 if structured else 1)
    nbytes = (px * c4 + (layers - 1) * px * c4o + px * c4o * out_size
              + layers * (9 * c4 * c4o + 3 * 4 * c4o + 2 * 4 * n * c4o))
    return bound_ms(ops, nbytes, "int8")


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on an NVIDIA GPU")
    sys.path.insert(0, str(REPO / "src"))
    from rpst_torch.bridge import load_weights
    from rpst_torch.config import load_config
    from rpst_torch.data import load_image
    from rpst_torch.kernels import build
    from rpst_torch.models import build_model
    from rpst_torch.models.fast_path import stylize_multi_adain_folded
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.ops.folded import fold_bias, fold_conv_kernel
    from rpst_torch.ops.folded_conv import (fused_folded_conv,
                                            fused_folded_conv_plain)
    from rpst_torch.serving import DynamicBatcher, make_run_impl, resolve_mode

    torch.backends.cudnn.allow_tf32 = False  # F.conv2d in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_main = time.perf_counter()
    name_power = card()
    log("card", f"{name_power} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    # one nvcc a source, all started together in the background; a phase
    # waits for the libraries it launches (``built``), so the longest build
    # (folded_conv2_q8.cu, B7: 16 instances) overlaps phases 2-11
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(len(build.SIGNATURES))
    builds = {lib: pool.submit(build.build, lib) for lib in build.SIGNATURES}

    def built(*libs):
        for lib in libs or tuple(build.SIGNATURES):
            builds[lib].result()  # raises a failed build's error
            build.load(lib)

    built("folded_conv", "folded_conv_bwd")
    log("1 build", f"B1-B3 built and loaded after "
        f"{time.perf_counter() - t0:.2f}s, the others building")

    # ---- 2. kernel vs plain -----------------------------------------------
    g = torch.Generator().manual_seed(0)

    def layer(n, h, w, c, co, dense=False):
        """x, a folded kernel (or a dense one: every block non-zero) and
        the folded bias of a c -> co layer."""
        bound = (9 * c) ** -0.5
        x = torch.rand(n, h, w, 4 * c, generator=g) * 2 - 0.5
        k = fold_conv_kernel((torch.rand(3, 3, c, co, generator=g) * 2 - 1)
                             * bound)
        if dense:
            k = (torch.rand(k.shape, generator=g) * 2 - 1) * bound / 2
        b = fold_bias((torch.rand(co, generator=g) * 2 - 1) * bound)
        return x.to(dev), k.to(dev).contiguous(), b.to(dev)

    cases = [("12->128", (1, 256, 256, 3, 32), 0.2, False),
             ("128->128", (1, 256, 256, 32, 32), 0.2, False),
             ("128->128 relu", (1, 256, 256, 32, 32), 0.0, False),
             ("128->12", (1, 256, 256, 32, 3), 0.2, False),
             ("VGG relu1_1 12->256", (1, 256, 256, 3, 64), 0.0, False),
             ("VGG relu1_2 256->256", (1, 256, 256, 64, 64), 0.0, False),
             ("VGG relu2_1 256->512", (1, 128, 128, 64, 128), 0.0, False),
             ("VGG relu2_2 512->512", (1, 128, 128, 128, 128), 0.0, False),
             ("ragged 2x38x22", (2, 38, 22, 32, 32), 0.2, False),
             ("rings override", (1, 64, 64, 32, 32), 0.2, True),
             ("2x2", (2, 2, 2, 32, 32), 0.2, False)]
    # the same function on dense kernels (all 144 blocks listed)
    cases += [(f"{label} dense", shape, alpha, rings, True)
              for label, shape, alpha, rings in cases
              if label in ("12->128", "128->128", "128->12",
                           "VGG relu2_2 512->512", "ragged 2x38x22",
                           "rings override", "2x2")]
    fused_folded_conv.launches = 0
    f32_err = 0.0
    with torch.inference_mode():
        for label, shape, alpha, with_rings, *dense in cases:
            x, k, b = layer(*shape, *dense)
            rings = None
            if with_rings:
                rings = (torch.rand(x.shape[0], 2, x.shape[2], x.shape[3],
                                    generator=g)).to(dev)
            for dt, tol in ((torch.float32, F32_TOL),
                            (torch.bfloat16, BF16_TOL)):
                xd, kd, bd = x.to(dt), k.to(dt), b.to(dt)
                rd = None if rings is None else rings.to(dt)
                y = fused_folded_conv(xd, kd, bd, alpha, rd)
                torch.cuda.synchronize()
                ref = fused_folded_conv_plain(
                    xd.float(), kd.float(), bd.float(), alpha,
                    None if rd is None else rd.float()).to(dt)
                err, _ = check_close(f"B1 {label} {dt}", y, ref, tol)
                if dt == torch.float32:
                    f32_err = max(f32_err, err)
                log("2 kernels", f"{label} x{tuple(x.shape)}->4Co "
                    f"{k.shape[3]} {str(dt)[6:]}: max abs err {err:.3g} "
                    f"(tol {tol})")
    log("2 kernels", f"{fused_folded_conv.launches} comparison launches")
    bwd = _timed(_check_backward_kernels, dev, name_power)
    b12 = _timed(_b1_b2_timing, dev, name_power)

    # ---- 3. slice vs the JAX reference fixture ----------------------------
    fx_path = REPO / "tests" / "fixtures" / "torch_port_flagship.npz"
    with np.load(fx_path) as fx:
        content, style, ref = (torch.from_numpy(fx[k]).to(dev)
                               for k in ("content", "style", "out"))
    fx_cfg = load_config(dict(FLAGSHIP, img_size=content.shape[1],
                              exec_strategy="folded"))
    fx_bundle = build_model(fx_cfg, dev)
    fx_bundle.load_state_dict(load_weights(fx_path))
    fused_folded_conv.launches = 0
    out = fx_bundle.stylize(content, style)
    torch.cuda.synchronize()
    err, mae = check_close("fixture", out, ref, F32_TOL, mae_max=1e-5)
    if fused_folded_conv.launches != 15:
        raise AssertionError(f"fixture: {fused_folded_conv.launches} B1 "
                             "launches, expected 15")
    log("3 fixture", f"folded f32 on the card vs rpst JAX (64px, rp5 h32): "
        f"max abs err {err:.3g}, MAE {mae:.3g}; 15 B1 launches")

    # ---- 4. 512px folded (B1) vs standard, bf16 vs f32 --------------------
    cfg = load_config(dict(FLAGSHIP, img_size=IMG, exec_strategy="folded"))
    bundle = build_model(cfg, dev)
    init_torch_default(bundle.model, cfg.seed)
    std_bundle = build_model(cfg.replace(exec_strategy="standard"), dev)
    std_bundle.load_state_dict(bundle.model.state_dict())
    rng = np.random.default_rng(0)
    c512 = torch.from_numpy(rng.random((2, IMG, IMG, 3), np.float32)).to(dev)
    s512 = torch.from_numpy(rng.random((2, IMG, IMG, 3), np.float32)).to(dev)
    fused_folded_conv.launches = 0
    folded = bundle.stylize(c512, s512)
    n_sep = fused_folded_conv.launches
    folded_2n = bundle.stylize(c512, s512, batch_encode=True)
    n_2n = fused_folded_conv.launches - n_sep
    standard = std_bundle.stylize(c512, s512)
    torch.cuda.synchronize()
    if (n_sep, n_2n) != (15, 10):
        raise AssertionError(f"B1 launches {n_sep} (separate encodes) / "
                             f"{n_2n} (2N encode), expected 15 / 10")
    err, mae = check_close("512 folded vs standard", folded, standard,
                           F32_TOL, mae_max=1e-5)
    err2, _ = check_close("512 2N encode", folded_2n, folded, F32_TOL,
                          mae_max=1e-5)
    with torch.inference_mode():
        folded_bf16 = stylize_multi_adain_folded(
            bundle.folded_weights(torch.bfloat16), c512, s512,
            dtype=torch.bfloat16)
    bf16_mae = (folded_bf16.float() - folded).abs().mean().item()
    if not (torch.isfinite(folded_bf16).all() and bf16_mae < 1e-2):
        raise AssertionError(f"bf16 folded vs f32 folded MAE {bf16_mae}")
    log("4 parity", f"512px b2 f32 folded(B1) vs standard: max abs err "
        f"{err:.3g}, MAE {mae:.3g}; 2N encode max err {err2:.3g}; bf16 vs "
        f"f32 MAE {bf16_mae:.3g}; launches 15 / 10")

    # ---- 5. the main path: serving through the user's entry points --------
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        from PIL import Image
        for sub in ("content", "style"):
            (tmp / sub).mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                            "RGB").save(tmp / "content" / f"c{i}.png")
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                        "RGB").save(tmp / "style" / "s.png")
        cfg_path = tmp / "cfg.yaml"
        cfg_path.write_text(json.dumps(dict(FLAGSHIP, img_size=IMG)))

        main_cfg = load_config(str(cfg_path), {"exec_strategy": "folded"})
        main_bundle = build_model(main_cfg, dev)
        init_torch_default(main_bundle.model, main_cfg.seed)
        run = make_run_impl(main_bundle, resolve_mode(main_bundle, "folded"))
        batcher = DynamicBatcher(run, batch_size=4, max_wait_ms=50.0,
                                 device=dev)
        imgs = [load_image(tmp / "content" / f"c{i}.png", IMG)
                for i in range(8)]
        style_img = load_image(tmp / "style" / "s.png", IMG)
        fused_folded_conv.launches = 0  # the main path's count starts here
        try:
            outs = [f.result(timeout=300) for f in
                    [batcher.submit(im, style_img) for im in imgs]]
        finally:
            batcher.close()
        main_launches = fused_folded_conv.launches
        if main_launches < 30 or main_launches % 15:
            raise AssertionError(f"main path: {main_launches} B1 launches "
                                 "for 8 requests in batches of 4")
        for o in outs:
            if o.shape != (IMG, IMG, 3) or not np.isfinite(o).all():
                raise AssertionError(f"main path output {o.shape} bad")
        log("5 serve", f"8 requests via DynamicBatcher(b4): "
            f"{batcher.stats()}, {main_launches} B1 launches")

        env = dict(os.environ)
        swept = tmp / "swept"
        t0 = time.perf_counter()
        out_log = _serve_cli(
            ["--config", str(cfg_path), "--content", str(tmp / "content"),
             "--style", str(tmp / "style" / "s.png"), "--out", str(swept),
             "--mode", "folded", "--batch", "4", "--device", "cuda"])
        pngs = sorted(swept.glob("*.png"))
        sweep_launches = _logged_launches(out_log)
        if len(pngs) != 8 or not sweep_launches > 0:
            raise AssertionError(f"sweep: {len(pngs)} PNGs, launches "
                                 f"{sweep_launches}:\n{out_log[-3000:]}")
        sweep_line = [ln for ln in out_log.splitlines() if "Stylized" in ln]
        log("5 serve", f"serve_torch.py sweep: 8 PNGs, {sweep_launches} B1 "
            f"launches in the child, {time.perf_counter() - t0:.1f}s wall; "
            f"{sweep_line[-1].split(' - ')[-1] if sweep_line else ''}")

        # ---- 6. daemon ----------------------------------------------------
        replies, stats = _daemon_round_trip(cfg_path, tmp, env)
        log("6 daemon", f"6/6 ok replies, stats {stats}")

    # ---- 7. timing --------------------------------------------------------
    def plain_lrelu(x, k, b):
        return fused_folded_conv_plain(x, k, b, 0.2)

    rows = []
    with torch.inference_mode():
        for batch in (1, 8):
            c = torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                            np.float32)).to(dev)
            s = torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                            np.float32)).to(dev)
            for dt in (torch.float32, torch.bfloat16):
                w = bundle.folded_weights(dt)
                paths = {
                    "folded B1": lambda: stylize_multi_adain_folded(
                        w, c, s, dtype=dt),
                    "folded plain": lambda: stylize_multi_adain_folded(
                        w, c, s, dtype=dt, conv=plain_lrelu),
                    "standard": lambda: _standard(std_bundle, c, s, dt),
                }
                # folded B1 against standard in both orders (the A/B of the
                # serving policy), plain between them
                for path in ("folded B1", "standard", "folded plain",
                             "standard", "folded B1"):
                    ms = cuda_ms(paths[path], iters=5, warmup=2)
                    rows.append((batch, str(dt)[6:], path, ms))
                    log("7 timing", f"512px b{batch} {str(dt)[6:]:8s} "
                        f"{path:12s}: {ms:8.3f} ms  "
                        f"{batch * 1e3 / ms:8.2f} img/s  ({name_power})")

    log("time", f"{time.perf_counter() - t_main:.1f}s before phases 8-11")
    # ---- 8-11. training ---------------------------------------------------
    _timed(_train_fixture, dev)
    _timed(_train_parity, dev, rng)
    train_launches = _timed(_train_main_path, dev, name_power)
    _timed(_train_timing, dev, rng, name_power)

    t0 = time.perf_counter()
    built()
    pool.shutdown()
    for lib in build.SIGNATURES:
        info = build.build_info[lib]
        regs = [ln.replace("ptxas info    :", "").strip()
                for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        log("1 build", f"{lib}.cu built in {info['seconds']:.2f}s; ptxas: "
            f"{regs}")
    log("1 build", f"all built and loaded; waited "
        f"{time.perf_counter() - t0:.2f}s for the last after phase 11")
    log("time", f"{time.perf_counter() - t_main:.1f}s before phases 12-16")
    # ---- 12-16. int8 (q8) serving -----------------------------------------
    q8k = _timed(_q8_kernels, dev, name_power)
    _timed(_q8_fixture, dev)
    _timed(_q8_parity, dev, rng)
    q8_launches = _timed(_q8_serve, dev, rng)
    _timed(_q8_timing, dev, rng, name_power, rows)

    log("time", f"{time.perf_counter() - t_main:.1f}s before phases 17-22")
    # ---- 17-22. the wide standard-layout path (B5) ------------------------
    b5k = _timed(_b5_kernels, dev, name_power)
    _timed(_wide_fixtures, dev)
    _timed(_q8_targets_fixture, dev)
    b5_serve = _timed(_wide_serve, dev, rng)
    q8t_launches = _timed(_q8_targets_train, dev)
    _timed(_wide_timing, dev, rng, name_power)

    log("time", f"{time.perf_counter() - t_main:.1f}s before phases 23-28")
    # ---- 23-28. the static SANet on B6 -----------------------------------
    b6k = _timed(_b6_kernels, dev, name_power)
    _timed(_sanet_fixture, dev)
    _timed(_sanet_parity, dev, rng)
    sanet_serve = _timed(_sanet_serve, dev, rng)
    sanet_train = _timed(_sanet_train, dev)
    _timed(_sanet_timing, dev, rng, name_power)

    log("time", f"{time.perf_counter() - t_main:.1f}s before phases 29-33")
    # ---- 29-33. slice 6b: dynamic_sanet and src on B5 ----------------------
    _timed(_6b_fixtures, dev)
    b5_6b = _timed(_6b_serve, dev, rng)
    _timed(_6b_train, dev)
    _timed(_6b_parity, dev, rng)
    _timed(_6b_timing, dev, rng, name_power)

    log("time", f"{time.perf_counter() - t_main:.1f}s before phases 34-38")
    # ---- 34-38. slice 4 (sel_multi_adain, ccam, mst), the target cache ----
    _timed(_s4_fixtures, dev)
    _timed(_s4_parity, dev, rng)
    s4_serve = _timed(_s4_serve, dev, rng)
    s4_train = _timed(_s4_train, dev)
    _timed(_s4_timing, dev, rng, name_power)

    log("time", f"{time.perf_counter() - t_main:.1f}s before phases 39-43")
    # ---- 39-43. slice 5b (mrf, spade, seg_adain), wct training -----------
    _timed(_5b_fixtures, dev)
    _timed(_5b_parity, dev, rng)
    b5_5b = _timed(_5b_serve, dev, rng)
    _timed(_5b_train, dev)
    _timed(_5b_timing, dev, rng, name_power)

    log("time", f"{time.perf_counter() - t_main:.1f}s before phases 44-48")
    # ---- 44-48. the LD family, B5's 7x7 form -------------------------------
    b5_7 = _timed(_ld_kernels, dev, name_power)
    _timed(_ld_fixtures, dev)
    ld_serve = _timed(_ld_serve, dev, rng)
    _timed(_ld_train, dev)
    _timed(_ld_timing, dev, rng, name_power)

    log("time", f"{time.perf_counter() - t_main:.1f}s before phase 49")
    # ---- 49. adain training on the card ------------------------------------
    _timed(_adain_train, dev, name_power)

    log("time", f"{time.perf_counter() - t_main:.1f}s before phases 50-53")
    # ---- 50-53. slice 7: masks, SE attention, the test dumps ---------------
    _timed(_masks_fixture, dev)
    _timed(_flagship_yaml, dev)
    _timed(_masks_timing, dev, rng, name_power)
    recon_b1 = _timed(_test_torch_paths, dev)

    log("time", f"{time.perf_counter() - t_main:.1f}s before phases 54-56")
    # ---- 54-56. slice 4's remainder, grad_accum and remat ------------------
    t0 = time.perf_counter()
    _s4r_fixture(dev)
    log("time", f"phase 54 {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    _deeper_yaml(dev, name_power)
    log("time", f"phase 55 {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    accum = _accum_remat(dev, name_power)
    log("time", f"phase 56 {time.perf_counter() - t0:.1f}s")

    log("time", f"{time.perf_counter() - t_main:.1f}s before phases 57-59")
    # ---- 57-59. slice 8a: the halo modes, two ranks on the one card -------
    t0 = time.perf_counter()
    halo = _halo_kernels(dev, name_power)
    log("time", f"phase 57 {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    sp_counts = _spatial_ranks(dev, name_power)
    log("time", f"phase 58 {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    cli_halo = _spatial_train_cli(dev)
    log("time", f"phase 59 {time.perf_counter() - t0:.1f}s")

    log("time", f"{time.perf_counter() - t_main:.1f}s before phases 60-62")
    # ---- 60-62. slice 8b: row-sharded SANet serving, the model axis, the
    # daemon over ranks; 60-61 in one launch of two ranks on the one card
    t0 = time.perf_counter()
    s8b, b6_shard, tp_share = _slice8b_ranks(dev, name_power)
    log("time", f"phases 60-61 {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    _mesh_daemon(dev)
    log("time", f"phase 62 {time.perf_counter() - t0:.1f}s")
    # ---- 63. slice 8c: the standard layout served row-sharded, two ranks
    # on the one card
    t0 = time.perf_counter()
    s8c = _slice8c_ranks(dev, name_power)
    log("time", f"phase 63 {time.perf_counter() - t0:.1f}s")
    # ---- 64. slice 8c: the standard layout trained row-sharded (in phase
    # 63's two ranks), the row-share B6b-d, the model axis beside spatial
    t0 = time.perf_counter()
    s8c_b6, b6_rows = _slice8c_train_check(s8c, dev, name_power, b6k)
    log("time", f"phase 64 {time.perf_counter() - t0:.1f}s")

    log("time", f"{time.perf_counter() - t_main:.1f}s for phases 1-64")
    # bounds at the shapes the times were taken at (phases 2, 12, 17)
    bnd = {
        # B1 and B2 at the timed folded kernel: its 36 listed blocks
        "B1": b12["B1"]["bound"],
        "B2": b12["B2"]["bound"],
        # B3 at the timed listed mode: the 36 blocks a fold lists
        "B3": bwd["B3"]["bound"],
        # B4 and B7 at the timed quantized folds: their 36 listed blocks
        "B4": q8_bound(1, 256, 256, 128, 128, True),
        "B7": q8_bound(1, 256, 256, 128, 128, True, layers=2),
    }
    bwd_src = "src/rpst_torch/csrc/folded_conv_bwd.cu"
    kernels = {"kernels": [
        {"name": "fused_folded_conv", "route": "cuda",
         "source": "src/rpst_torch/csrc/folded_conv.cu",
         "replaces": "src/rpst/ops/pallas/folded_conv.py:650",
         "launches": (main_launches + train_launches[0] + q8_launches["B1"]
                      + q8t_launches[0] + s4_serve["B1"] + s4_train[0]
                      + recon_b1 + accum[0] + s8b["B1"]),
         "max_abs_err": f32_err, "ms": b12["B1"]["ms"],
         "plain_ms": b12["B1"]["plain_ms"], "bound_ms": bnd["B1"][0],
         "bound_by": bnd["B1"][1], "library_ms": b12["B1"]["library_ms"]},
        {"name": "fused_folded_conv_grad_input", "route": "cuda",
         "source": bwd_src,
         "replaces": "src/rpst/ops/pallas/folded_conv.py:339",
         "launches": (train_launches[1] + q8t_launches[1] + s4_train[1]
                      + accum[1] + s8b["B2"]),
         "max_abs_err": bwd["B2"]["err"], "ms": b12["B2"]["ms"],
         "plain_ms": b12["B2"]["plain_ms"], "bound_ms": bnd["B2"][0],
         "bound_by": bnd["B2"][1], "library_ms": b12["B2"]["library_ms"]},
        {"name": "fused_folded_conv_grad_weight", "route": "cuda",
         "source": bwd_src,
         "replaces": "src/rpst/ops/pallas/folded_conv.py:468",
         "launches": (train_launches[2] + q8t_launches[2] + s4_train[2]
                      + accum[2] + s8b["B3"]),
         "max_abs_err": bwd["B3"]["err"], "ms": bwd["B3"]["ms"],
         "plain_ms": bwd["B3"]["plain_ms"], "bound_ms": bnd["B3"][0],
         "bound_by": bnd["B3"][1], "library_ms": bwd["B3"]["library_ms"]},
        {"name": "fused_folded_conv_q8", "route": "cuda",
         "source": "src/rpst_torch/csrc/folded_conv_q8.cu",
         "replaces": "src/rpst/ops/pallas/folded_conv_q8.py:281",
         "launches": q8_launches["B4"] + s4_serve["B4"],
         "max_abs_err": q8k["B4"]["err"],
         "ms": q8k["B4"]["ms"], "plain_ms": q8k["B4"]["plain_ms"],
         "bound_ms": bnd["B4"][0], "bound_by": bnd["B4"][1],
         "library_ms": None},
        {"name": "fused_folded_conv2_q8", "route": "cuda",
         "source": "src/rpst_torch/csrc/folded_conv2_q8.cu",
         "replaces": "src/rpst/ops/pallas/folded_conv2_q8.py:254",
         "launches": q8_launches["B7"], "max_abs_err": q8k["B7"]["err"],
         "ms": q8k["B7"]["ms"], "plain_ms": q8k["B7"]["plain_ms"],
         "bound_ms": bnd["B7"][0], "bound_by": bnd["B7"][1],
         "library_ms": None},
        # B5's numbers at the widest shape of the adain path (phase 17);
        # library_ms is F.conv2d in bfloat16 on the dequantized values
        {"name": "fused_conv2d_q8", "route": "cuda",
         "source": "src/rpst_torch/csrc/conv2d_q8.cu",
         "replaces": "src/rpst/ops/pallas/conv2d_q8.py:220",
         "launches": (b5_serve + q8t_launches[3] + sanet_serve["B5"]
                      + b5_6b + b5_5b + ld_serve[0] - ld_serve[1]),
         "max_abs_err": b5k["err"], "ms": b5k["ms"],
         "plain_ms": b5k["plain_ms"], "bound_ms": b5k["bound_ms"],
         "bound_by": b5k["bound_by"], "library_ms": b5k["library_ms"]},
        # B5's 7x7 form (wgmma) at LD v1's widest shape, (2, 512, 512, 256
        # -> 256) (phase 44): it replaces no Pallas kernel but what rpst
        # asks of its compiler's int8 conv (_xla_conv_q8); library_ms is
        # F.conv2d bf16 7x7 on the dequantized values, not the same function
        # (no PyTorch call takes int8 on CUDA); its launches are LD v1's q8
        # main path's (phase 46)
        {"name": "fused_conv2d_q8_7x7", "route": "cuda",
         "source": "src/rpst_torch/csrc/conv2d_q8_7x7.cu",
         "replaces": "src/rpst/models/fast_path_q8.py:1415",
         "launches": ld_serve[1], "max_abs_err": b5_7["err"],
         "ms": b5_7["ms"], "plain_ms": b5_7["plain_ms"],
         "bound_ms": b5_7["bound_ms"], "bound_by": b5_7["bound_by"],
         "library_ms": b5_7["library_ms"]},
        # the halo modes of B2 and B3 (one row shard's backward, slice 8a),
        # rows of their own: timed at HALO_SHAPE f32 with a folded kernel
        # (phase 57; B3 in the listed mode the row-sharded step runs), their
        # launches those of phases 58 (both ranks) and 59 (rank 0)
        {"name": "fused_folded_conv_grad_input_halo", "route": "cuda",
         "source": bwd_src, "mode": "row_rings=False",
         "replaces": "src/rpst/ops/pallas/folded_conv.py:339",
         "launches": sp_counts[3] + cli_halo[0], **halo["B2"]},
        {"name": "fused_folded_conv_grad_weight_rings", "route": "cuda",
         "source": bwd_src, "mode": "rings",
         "replaces": "src/rpst/ops/pallas/folded_conv.py:468",
         "launches": sp_counts[4] + cli_halo[1], **halo["B3"]}]}
    # B1-B3 at the flagship's share width on {model: 2} (phase 61), rows of
    # their own: their launches those of phase 61's folded steps (both
    # ranks; the one-device rows above count them too)
    for name, key, line in (("fused_folded_conv", "B1", 650),
                            ("fused_folded_conv_grad_input", "B2", 339),
                            ("fused_folded_conv_grad_weight", "B3", 468)):
        kernels["kernels"].append(
            {"name": f"{name}_model_share", "route": "cuda",
             "source": ("src/rpst_torch/csrc/folded_conv.cu" if key == "B1"
                        else bwd_src),
             "mode": f"model axis share {TP_SHARE_SHAPE}",
             "replaces": f"src/rpst/ops/pallas/folded_conv.py:{line}",
             "launches": s8b[key], **tp_share[key]})
    # B6's numbers at relu4_1 of a 512px stylize, (1, 4096, 4096, 512) f32
    # (phase 23); library_ms is F.scaled_dot_product_attention(scale=1.0)
    # forward for B6a / B6b and its autograd backward, which yields dQ, dK
    # and dV together, for B6c and B6d. Each bfloat16 kernel is a kernel of
    # its own (tensor cores, one bf16 product a fragment), held against its
    # plain version in phase 23; the one-device static transform runs
    # float32 as rpst's (its flax convs take no dtype), so only the
    # row-sharded bfloat16 stylize (phase 60, rpst's stylize_sanet_spatial
    # in compute_dtype) launches the bfloat16 forward; no path launches the
    # bfloat16 forward with LSE or backward
    b6_launches = {"B6a": sanet_serve["B6a"] + s8b["B6a"],
                   "B6b": sanet_train[0] + s8b["B6b"] + s8c_b6[0],
                   "B6c": sanet_train[1] + s8b["B6c"] + s8c_b6[1],
                   "B6d": sanet_train[2] + s8b["B6d"] + s8c_b6[2],
                   "B6a_bf16": sanet_serve["B6a_bf16"] + s8b["B6a_bf16"],
                   "B6b_bf16": 0, "B6c_bf16": 0, "B6d_bf16": 0}
    for key, fn_name, line in (("B6a", "flash_fwd", 260),
                               ("B6b", "flash_fwd_lse", 109),
                               ("B6c", "flash_bwd_dq", 220),
                               ("B6d", "flash_bwd_dkv", 240),
                               ("B6a_bf16", "flash_fwd_bf16", 260),
                               ("B6b_bf16", "flash_fwd_lse_bf16", 109),
                               ("B6c_bf16", "flash_bwd_dq_bf16", 220),
                               ("B6d_bf16", "flash_bwd_dkv_bf16", 240)):
        kernels["kernels"].append(
            {"name": fn_name, "route": "cuda",
             "source": "src/rpst_torch/csrc/flash_attention.cu",
             "replaces": f"src/rpst/ops/pallas/flash_attention.py:{line}",
             "launches": b6_launches[key], **b6k[key]})
    # B6a on one row share of {spatial: 2} (phase 60), f32 and bf16, rows
    # of their own; their launches those of phase 60 (both ranks)
    for kind, name, key in (("f32", "flash_fwd", "B6a"),
                            ("bf16", "flash_fwd_bf16", "B6a_bf16")):
        kernels["kernels"].append(
            {"name": f"{name}_row_share", "route": "cuda",
             "source": "src/rpst_torch/csrc/flash_attention.cu",
             "mode": f"spatial row share {B6_SHARD_SHAPE}",
             "replaces": "src/rpst/ops/pallas/flash_attention.py:260",
             "launches": s8b[key], **b6_shard[kind]})
    # B6b-d on one row share of {spatial: 2} (phase 64), f32 and bf16, rows
    # of their own; their launches those of phase 64's sanet steps (both
    # ranks), all float32: the row-sharded step runs one device's loss,
    # whose transform is float32 in either compute_dtype, as rpst's
    for kind, suffix in (("f32", ""), ("bf16", "_bf16")):
        for i, (key, name, line) in enumerate((
                ("B6b", "flash_fwd_lse", 109), ("B6c", "flash_bwd_dq", 220),
                ("B6d", "flash_bwd_dkv", 240))):
            kernels["kernels"].append(
                {"name": f"{name}{suffix}_row_share", "route": "cuda",
                 "source": "src/rpst_torch/csrc/flash_attention.cu",
                 "mode": f"spatial row share {B6_SHARD_SHAPE}",
                 "replaces": f"src/rpst/ops/pallas/flash_attention.py:{line}",
                 "launches": s8c_b6[i] if kind == "f32" else 0,
                 **b6_rows[(kind, key)]})
    for k in kernels["kernels"]:
        if not (k["launches"] > 0 or k["name"] in OFF_PATH):
            raise AssertionError(f"{k['name']} was launched no time on the "
                                 "main paths")
    print(json.dumps(kernels), flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _timed(fn, *args):
    """``fn(*args)``, logging its wall time as a ``[time]`` line."""
    t0 = time.perf_counter()
    out = fn(*args)
    log("time", f"{fn.__name__} {time.perf_counter() - t0:.1f}s")
    return out


def _grad_case(g, dev, n, h, w, c4, c4o, folded=False):
    """x, gz and khat of a layer: khat of a dense random kernel, or of one
    from fold_conv_kernel (36 of 144 blocks non-zero)."""
    import torch
    from rpst_torch.ops.folded import fold_conv_kernel
    x = torch.randn(n, h, w, c4, generator=g)
    gz = torch.randn(n, h, w, c4o, generator=g)
    kf = torch.randn(3, 3, c4, c4o, generator=g) * 0.1
    if folded:
        kf = fold_conv_kernel(torch.randn(3, 3, c4 // 4, c4o // 4,
                                          generator=g) * 0.2)
    return (x.to(dev), gz.to(dev),
            kf.flip(0, 1).transpose(2, 3).contiguous().to(dev))


def _plain_act(x_f, folded_kernel, folded_bias, alpha, listed=False):
    """B1's plain version as a ``conv_act`` (autograd of plain PyTorch
    computes every block; ``listed`` changes nothing there)."""
    from rpst_torch.ops.folded_conv import fused_folded_conv_plain
    return fused_folded_conv_plain(x_f, folded_kernel, folded_bias, alpha)


def _unfolded_kernel_grad(dk):
    """The image kernel's gradient (3, 3, C, Co) that a folded kernel's
    gradient dk (3, 3, 4C, 4Co) sends back through fold_conv_kernel: each
    tap's four placements summed (the einsum's backward)."""
    import torch
    from rpst_torch.ops.folded import _fold_placement
    c, co = dk.shape[2] // 4, dk.shape[3] // 4
    p = _fold_placement(torch.float32, dk.device)
    k = torch.einsum("abstk,absito->kio", p, dk.reshape(3, 3, 4, c, 4, co))
    return k.reshape(3, 3, c, co)


def _check_b3(label, xd, gd, dk_atol):
    """B3 in both modes against its plain version (rtol 1e-4, atol
    dk_atol), each bit-equal across two runs, and the listed mode's
    unfolded-kernel gradient against the dense mode's (the same limits);
    returns the max abs error."""
    import torch
    from rpst_torch.ops.folded_conv import (
        fused_folded_conv_grad_weight, fused_folded_conv_grad_weight_plain)

    def close(name, got, ref):
        if not (torch.isfinite(got).all() and torch.allclose(
                got, ref, rtol=1e-4, atol=dk_atol)):
            raise AssertionError(
                f"B3 {label} {name}: max abs err "
                f"{(got - ref).abs().max().item()} (rtol 1e-4, atol "
                f"{dk_atol:.3g})")
        return (got - ref).abs().max().item()

    err, out = 0.0, {}
    for mode, listed in (("dense", False), ("listed", True)):
        dk, db = fused_folded_conv_grad_weight(xd, gd, listed)
        dk2, db2 = fused_folded_conv_grad_weight(xd, gd, listed)
        torch.cuda.synchronize()
        if not (torch.equal(dk, dk2) and torch.equal(db, db2)):
            raise AssertionError(f"B3 {label} {mode}: two runs differ")
        rdk, rdb = fused_folded_conv_grad_weight_plain(xd, gd, listed)
        err = max(err, close(f"{mode} dk", dk, rdk), close(f"{mode} db", db,
                                                          rdb))
        out[mode] = dk
    close("listed vs dense, unfolded kernel gradient",
          _unfolded_kernel_grad(out["listed"]),
          _unfolded_kernel_grad(out["dense"]))
    return err


def _check_backward_kernels(dev, name_power):
    """Phase 2, backward: B2 and B3 against their plain versions at every
    width of the training path, f32 and bf16, B2 with dense and with folded
    kernels, B3 dense and listed (``_check_b3``); B3 timed in both modes
    against plain, torch.nn.grad.conv2d_weight on the ring-padded folded
    tensor and on the reflect-padded unfolded image (what the standard path
    runs) at (1,256,256,128->128) and (1,128,128,512->512). Returns the f32
    max abs errors and B3's listed 128->128 f32 times for the kernels
    JSON."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight
    from rpst_torch.ops.folded import folded_reflect_pad, unfold
    from rpst_torch.ops.folded_conv import (
        fused_folded_conv_grad_input, fused_folded_conv_grad_input_plain,
        fused_folded_conv_grad_weight, fused_folded_conv_grad_weight_plain)
    g = torch.Generator().manual_seed(1)
    # (label, (N, H, W, 4C, 4Co)): the RP stack at 512px, the folded VGG
    # layers relu1_1/1_2 at 256x256 and relu2_1/2_2 at 128x128, a ragged
    # batch and the smallest foldable image
    cases = [("RP 12->128", (1, 256, 256, 12, 128)),
             ("RP 128->128", (1, 256, 256, 128, 128)),
             ("RP 128->12", (1, 256, 256, 128, 12)),
             ("VGG relu1_1 12->256", (1, 256, 256, 12, 256)),
             ("VGG relu1_2 256->256", (1, 256, 256, 256, 256)),
             ("VGG relu2_1 256->512", (1, 128, 128, 256, 512)),
             ("VGG relu2_2 512->512", (1, 128, 128, 512, 512)),
             ("ragged 2x38x22", (2, 38, 22, 128, 128)),
             ("2x2", (2, 2, 2, 12, 12))]
    # khat of folded kernels: B2 takes their 36 listed blocks
    cases += [(f"{label} folded", shape, True) for label, shape in cases
              if label in ("RP 12->128", "RP 128->128", "RP 128->12",
                           "VGG relu2_2 512->512", "ragged 2x38x22", "2x2")]
    err = {"B2": 0.0, "B3": 0.0}
    for label, shape, *folded in cases:
        x, gz, khat = _grad_case(g, dev, *shape, *folded)
        n, h, w = shape[:3]
        dk_atol = DK_ATOL_512 * (n * h * w / 512) ** 0.5
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            xd, gd, kd = x.to(dt), gz.to(dt), khat.to(dt)
            dx = fused_folded_conv_grad_input(gd, kd)
            torch.cuda.synchronize()
            e2, _ = check_close(f"B2 {label} {dt}", dx,
                                fused_folded_conv_grad_input_plain(gd, kd),
                                tol)
            e3 = _check_b3(f"{label} {dt}", xd, gd, dk_atol)
            if dt == torch.float32:
                err["B2"], err["B3"] = max(err["B2"], e2), max(err["B3"], e3)
            log("2 kernels", f"{label} {tuple(shape)} {str(dt)[6:]}: B2 dx "
                f"max abs err {e2:.3g} (tol {tol}), B3 dk/db dense and "
                f"listed {e3:.3g} (atol {dk_atol:.3g}; bit-equal across two "
                f"runs; listed = dense through the fold)")
    out = {"B2": {"err": err["B2"]}, "B3": {"err": err["B3"]}}
    for shape in ((1, 256, 256, 128, 128), (1, 128, 128, 512, 512)):
        n, h, w, c4, c4o = shape
        x, gz, _ = _grad_case(g, dev, *shape)
        for dt in (torch.float32, torch.bfloat16):
            kind, size = ("f32", 4) if dt == torch.float32 else ("bf16", 2)
            xd, gd = x.to(dt), gz.to(dt)
            # the library calls: the kernel gradient of one conv over the
            # ring-padded folded tensor (all 144 blocks), and of the
            # unfolded conv over the reflect-padded image
            xp = folded_reflect_pad(xd).permute(0, 3, 1, 2)
            gp = gd.permute(0, 3, 1, 2)
            xu = F.pad(unfold(xd).permute(0, 3, 1, 2), (1, 1, 1, 1),
                       mode="reflect")
            gu = unfold(gd).permute(0, 3, 1, 2)
            lib = {"folded": cuda_ms(lambda: conv2d_weight(
                       xp, (c4o, c4, 3, 3), gp)),
                   "unfolded": cuda_ms(lambda: conv2d_weight(
                       xu, (c4o // 4, c4 // 4, 3, 3), gu))}
            for mode, listed in (("dense", False), ("listed", True)):
                t = {"B3": cuda_ms(lambda: fused_folded_conv_grad_weight(
                         xd, gd, listed)),
                     "B3 plain": cuda_ms(
                         lambda: fused_folded_conv_grad_weight_plain(
                             xd, gd, listed))}
                bnd = folded_bound(n, h, w, c4, c4o, kind, size, listed)
                tf3 = ""
                if kind == "f32":  # three TF32 products: 3x the operations
                    ops = 2 * 9 * n * h * w * c4 * c4o // (4 if listed else 1)
                    tf3 = (f", 3xTF32 ceiling "
                           f"{3 * ops / PEAK_OPS['f32'] * 1e3:.4f}")
                log("2 kernels", f"B3 {tuple(shape)} {kind} {mode}: "
                    f"{t['B3']:.4f} ms vs plain {t['B3 plain']:.4f}, "
                    f"conv2d_weight on the ring-padded tensor "
                    f"{lib['folded']:.4f}, on the unfolded image "
                    f"{lib['unfolded']:.4f}; bound {bnd[0]:.4f} ms by "
                    f"{bnd[1]}{tf3} ({100 * bnd[0] / t['B3']:.1f}% of it; "
                    f"{name_power})")
                if (c4, kind, mode) == (128, "f32", "listed"):
                    out["B3"].update(ms=t["B3"], plain_ms=t["B3 plain"],
                                     library_ms=lib["folded"], bound=bnd)
    return out


def folded_bound(n, h, w, c4, c4o, kind, size, structured):
    """bound_ms of B1 / B2 at (N, Hf, Wf, 4C -> 4Co): the operations of the
    listed blocks (all 144 of a dense kernel; the 36 of a folded one, the
    unfolded conv's) at the peak of ``kind``; the input, the kernel and the
    output moved once, ``size`` bytes each."""
    px = n * h * w
    ops = 2 * 9 * px * c4 * c4o // (4 if structured else 1)
    return bound_ms(ops, (px * (c4 + c4o) + 9 * c4 * c4o) * size, kind)


def _b1_b2_timing(dev, name_power):
    """Phase 2, timing: B1 and B2 at (1,256,256,128->128) and
    (1,128,128,512->512), f32 and bf16, with a folded kernel and a dense
    one, beside the plain version, the library call on the folded layout
    (F.conv2d on the ring-padded tensor; torch.nn.grad.conv2d_input on it),
    the unfolded conv the standard path runs for a folded kernel (reflect
    pad + F.conv2d on (N, C, 2H, 2W); conv2d_input there) and the dense and
    structured bounds. The kernels' times include each launch's packing
    and block table (a small kernel ahead of the main one). Returns the
    kernels JSON numbers: f32, 128->128, folded."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input
    from rpst_torch.ops.folded import (fold_bias, fold_conv_kernel,
                                       folded_reflect_pad, unfold)
    from rpst_torch.ops.folded_conv import (
        fused_folded_conv, fused_folded_conv_grad_input,
        fused_folded_conv_grad_input_plain, fused_folded_conv_plain)
    g = torch.Generator().manual_seed(2)
    cl = torch.channels_last
    out = {}
    for n, h, w, c4, c4o in ((1, 256, 256, 128, 128),
                             (1, 128, 128, 512, 512)):
        c, co = c4 // 4, c4o // 4
        x = torch.randn(n, h, w, c4, generator=g)
        gz = torch.randn(n, h, w, c4o, generator=g)
        k3 = torch.randn(3, 3, c, co, generator=g) * (9 * c) ** -0.5
        b = torch.randn(co, generator=g) * 0.1
        kinds = {"folded": fold_conv_kernel(k3),
                 "dense": torch.randn(3, 3, c4, c4o, generator=g)
                 * (9 * c4) ** -0.5}
        for dt in (torch.float32, torch.bfloat16):
            kind, size = ("f32", 4) if dt == torch.float32 else ("bf16", 2)
            xd, gd = x.to(dev, dt), gz.to(dev, dt)
            bu = b.to(dev, dt)
            bd = fold_bias(bu)
            xp = folded_reflect_pad(xd).permute(0, 3, 1, 2)
            gp = gd.permute(0, 3, 1, 2)
            # the unfolded layer: (N, C, 2H, 2W) channels-last views
            xu = unfold(xd).permute(0, 3, 1, 2)
            gu = unfold(gd).permute(0, 3, 1, 2)
            wu = k3.to(dev, dt).permute(3, 2, 0, 1).contiguous(
                memory_format=cl)
            unfolded = {
                "B1": cuda_ms(lambda: F.conv2d(
                    F.pad(xu, (1, 1, 1, 1), mode="reflect"), wu, bu)),
                "B2": cuda_ms(lambda: conv2d_input(
                    (n, c, 2 * h + 2, 2 * w + 2), wu, gu))}
            for kname, kf in kinds.items():
                kd = kf.to(dev, dt).contiguous()
                khat = kd.flip(0, 1).transpose(2, 3).contiguous()
                wf = kd.permute(3, 2, 0, 1).contiguous(memory_format=cl)
                t = {"B1": cuda_ms(lambda: fused_folded_conv(xd, kd, bd, 0.2)),
                     "B1 plain": cuda_ms(
                         lambda: fused_folded_conv_plain(xd, kd, bd, 0.2)),
                     "B1 lib": cuda_ms(lambda: F.conv2d(xp, wf, bd)),
                     "B2": cuda_ms(
                         lambda: fused_folded_conv_grad_input(gd, khat)),
                     "B2 plain": cuda_ms(
                         lambda: fused_folded_conv_grad_input_plain(gd, khat)),
                     "B2 lib": cuda_ms(lambda: conv2d_input(xp.shape, wf, gp))}
                bounds = [folded_bound(n, h, w, c4, c4o, kind, size, s)
                          for s in (False, True)]
                listed = bounds[1] if kname == "folded" else bounds[0]
                tf3 = ""
                if kind == "f32":  # three TF32 products: 3x the operations
                    ops = 2 * 9 * n * h * w * c4 * c4o \
                        // (4 if kname == "folded" else 1)
                    tf3 = (f", 3xTF32 ceiling "
                           f"{3 * ops / PEAK_OPS['f32'] * 1e3:.4f}")
                for op in ("B1", "B2"):
                    unf = (f", unfolded {unfolded[op]:.4f}"
                           if kname == "folded" else "")
                    log("2 kernels", f"{op} ({n},{h},{w},{c4}->{c4o}) "
                        f"{kind} {kname}: {t[op]:.4f} ms vs plain "
                        f"{t[op + ' plain']:.4f}, lib {t[op + ' lib']:.4f}"
                        f"{unf}; bound dense {bounds[0][0]:.4f} / "
                        f"structured {bounds[1][0]:.4f} ms{tf3} "
                        f"({100 * listed[0] / t[op]:.1f}% of the listed "
                        f"blocks' bound; {name_power})")
                if (c4, kind, kname) == (128, "f32", "folded"):
                    for op in ("B1", "B2"):
                        out[op] = {"ms": t[op], "plain_ms": t[op + " plain"],
                                   "library_ms": t[op + " lib"],
                                   "bound": bounds[1]}
    return out


def _counters():
    from rpst_torch.ops.folded_conv import (fused_folded_conv,
                                            fused_folded_conv_grad_input,
                                            fused_folded_conv_grad_weight)
    from rpst_torch.ops.folded_conv2_q8 import fused_folded_conv2_q8
    from rpst_torch.ops.conv2d_q8 import fused_conv2d_q8
    from rpst_torch.ops.flash_attention import (flash_bwd_dkv, flash_bwd_dq,
                                                flash_fwd, flash_fwd_lse)
    from rpst_torch.ops.folded_conv_q8 import fused_folded_conv_q8
    return {"B1": fused_folded_conv, "B2": fused_folded_conv_grad_input,
            "B3": fused_folded_conv_grad_weight, "B4": fused_folded_conv_q8,
            "B7": fused_folded_conv2_q8, "B5": fused_conv2d_q8,
            "B6a": flash_fwd, "B6b": flash_fwd_lse, "B6c": flash_bwd_dq,
            "B6d": flash_bwd_dkv}


_COUNT_ATTRS = ("launches", "launches_bf16", "launches_7x7", "launches_halo",
                "launches_rings")


def _reset_counts():
    for c in _counters().values():
        for sub in _COUNT_ATTRS:
            if hasattr(c, sub):
                setattr(c, sub, 0)


def _bf16_fwd_counts():
    """(B6a, B6b) launches of the bfloat16 (tensor-core) forward kernel."""
    c = _counters()
    return c["B6a"].launches_bf16, c["B6b"].launches_bf16


def _counts(names=("B1", "B2", "B3")):
    """The launch counts of ``names``: the train step's kernels by default,
    a dict of the q8 path's with ``Q8_KERNELS``."""
    c = _counters()
    if names == Q8_KERNELS:
        return {k: c[k].launches for k in names}
    return tuple(c[k].launches for k in names)


def _serve_cli(argv):
    """``serve_torch.py`` (one device) run in this process on ``argv``: its
    ``main``, the entry point its command line calls, without an
    interpreter's start-up (~10 s of each run as a subprocess). The launch
    counts start from 0, as in a fresh process, and are put back after the
    run. Returns the port logger's lines as the command prints them; a
    failing run raises."""
    import importlib.util
    import logging
    spec = importlib.util.spec_from_file_location("serve_torch",
                                                  REPO / "serve_torch.py")
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(self.format(record))
    handler = Keep()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    logger = logging.getLogger("rpst_torch")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    counters = _counters()
    saved = {k: {a: getattr(c, a) for a in _COUNT_ATTRS if hasattr(c, a)}
             for k, c in counters.items()}
    _reset_counts()
    try:
        driver.main(list(argv))
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
        for k, attrs in saved.items():
            for a, v in attrs.items():
                setattr(counters[k], a, v)
    return "\n".join(lines)


def _train_cli(argv):
    """``train_torch.py`` run in this process on ``argv``: its ``main``, the
    entry point its command line calls, without an interpreter's start-up
    (~15 s of each run as a subprocess), the launch counts reset first.
    Returns a ``CompletedProcess`` whose stdout holds the port logger's
    messages; a failing run raises."""
    import importlib.util
    import logging
    spec = importlib.util.spec_from_file_location("train_torch",
                                                  REPO / "train_torch.py")
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())
    handler = Keep()
    logger = logging.getLogger("rpst_torch")
    logger.addHandler(handler)
    _reset_counts()
    try:
        driver.main(list(argv))
    finally:
        logger.removeHandler(handler)
    return subprocess.CompletedProcess(argv, 0, "\n".join(lines), "")


def _grad_dict(model):
    return {n: p.grad.detach().float().clone()
            for n, p in model.named_parameters()}


def _check_grads(label, got, ref):
    """Raise unless every gradient is within GRAD_RTOL and GRAD_ATOL_REL x
    its reference's max; return the worst max abs err / max |ref|."""
    import torch
    worst = 0.0
    for name, r in ref.items():
        a = got[name]
        scale = r.abs().max().item()
        if not (torch.isfinite(a).all() and torch.allclose(
                a, r, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * scale)):
            raise AssertionError(f"{label} {name}: max abs err "
                                 f"{(a - r).abs().max().item()} vs max |ref| "
                                 f"{scale}")
        worst = max(worst, (a - r).abs().max().item() / max(scale, 1e-30))
    return worst


def _train_fixture(dev):
    """Phase 8: the card's folded train step vs rpst's JAX loss, gradients
    and 3-step trajectory in tests/fixtures/torch_port_train.npz."""
    import numpy as np
    import torch
    from rpst_torch.bridge import (flax_tree_from_npz, from_flax_params,
                                   vgg_from_flax, vgg_weights_from_seed)
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.vgg import VGG19Encoder
    from rpst_torch.train.step import create_train_state, train_step

    with np.load(REPO / "tests" / "fixtures" / "torch_port_train.npz") as npz:
        tree = flax_tree_from_npz(npz)
        fx = {k: npz[k] for k in npz.files if "/" not in k}
    ref_grads = {k: v.to(dev) for k, v in
                 from_flax_params(tree.pop("grads")).items()}
    cfg = load_config(dict(FLAGSHIP, img_size=fx["content"].shape[1],
                           exec_strategy="folded", lr=float(fx["lr"]),
                           lr_decay=float(fx["lr_decay"])))
    bundle = build_model(cfg, dev)
    bundle.load_state_dict(from_flax_params(tree))
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]))))
    vgg = vgg.to(dev)
    c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
    _reset_counts()
    total, parts = bundle.loss(vgg, c, s)
    total.backward()
    torch.cuda.synchronize()
    if _counts() != PER_STEP:
        raise AssertionError(f"train fixture: B1/B2/B3 launches {_counts()}, "
                             f"expected {PER_STEP}")
    for k in ("content_loss", "style_loss", "total_loss"):
        got, want = float(parts[k].detach()), float(fx[k])
        if not abs(got - want) <= LOSS_RTOL * abs(want):
            raise AssertionError(f"train fixture {k}: {got} vs rpst {want}")
    worst = _check_grads("train fixture grad", _grad_dict(bundle.model),
                         ref_grads)
    bundle.model.zero_grad(set_to_none=True)
    state = create_train_state(bundle)
    traj = [float(train_step(state, vgg, c, s)["total_loss"])
            for _ in range(len(fx["trajectory"]))]
    if not np.allclose(traj, fx["trajectory"], rtol=LOSS_RTOL, atol=0):
        raise AssertionError(f"train trajectory {traj} vs rpst "
                             f"{fx['trajectory'].tolist()}")
    log("8 train fixture", f"64px b2 f32 vs rpst JAX: loss "
        f"{float(parts['total_loss'].detach()):.7g} vs {float(fx['total_loss']):.7g}; "
        f"worst grad err / max {worst:.3g}; trajectory {traj} vs "
        f"{fx['trajectory'].tolist()}; B1/B2/B3 {PER_STEP} per step")


def _train_parity(dev, rng):
    """Phase 9: 512px b2 f32 loss and gradients, kernel path vs plain path
    vs standard; bf16 vs f32 gradient cosines."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.nn.blocks import init_torch_default

    cfg = load_config(dict(FLAGSHIP, img_size=IMG, exec_strategy="folded"))
    vgg, _ = build_vgg(cfg, dev)
    c, s = (torch.from_numpy(rng.random((2, IMG, IMG, 3), np.float32)).to(dev)
            for _ in range(2))
    runs = {}
    for label, over, conv_act in (
            ("kernels", {}, None), ("plain", {}, _plain_act),
            ("standard", {"exec_strategy": "standard"}, None),
            ("bf16", {"compute_dtype": "bfloat16"}, None)):
        bundle = build_model(cfg.replace(**over), dev)
        init_torch_default(bundle.model, cfg.seed)
        kw = {} if conv_act is None else {"conv_act": conv_act}
        _reset_counts()
        total, _ = bundle.loss(vgg, c, s, **kw)
        total.backward()
        torch.cuda.synchronize()
        runs[label] = (float(total.detach()), _grad_dict(bundle.model),
                       _counts())
    if runs["kernels"][2] != PER_STEP or runs["plain"][2] != (0, 0, 0):
        raise AssertionError(f"launches kernels {runs['kernels'][2]}, plain "
                             f"{runs['plain'][2]}")
    loss, grads, _ = runs["kernels"]
    msg = []
    for label in ("plain", "standard"):
        ref_loss, ref_grads, _ = runs[label]
        if not abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss):
            raise AssertionError(f"{IMG}px train loss {loss} vs {label} "
                                 f"{ref_loss}")
        worst = _check_grads(f"{IMG}px train grad vs {label}", grads,
                             ref_grads)
        msg.append(f"vs {label}: loss {loss:.7g} / {ref_loss:.7g}, worst "
                   f"grad err / max {worst:.3g}")
    cos = {}
    for name, a in grads.items():
        b = runs["bf16"][1][name]
        cos[name] = float((a * b).sum() / (a.norm() * b.norm()))
    worst_name = min(cos, key=cos.get)
    if not cos[worst_name] > BF16_COS:
        raise AssertionError(f"bf16 vs f32 gradient cosine {cos[worst_name]} "
                             f"at {worst_name} <= {BF16_COS}")
    log("9 train parity", f"{IMG}px b2 f32 kernels {'; '.join(msg)}; bf16 vs "
        f"f32 worst gradient cosine {cos[worst_name]:.6f} ({worst_name}, "
        f"bound > {BF16_COS}); launches {runs['kernels'][2]}")


# phase 10's decoder corpus: 32 JPEGs (quality 90) and 32 PNGs of 1024x768,
# decoded to 512px by the port's four loader threads (num_workers' default)
DECODE_FILES, DECODE_SIZE, DECODE_THREADS = 32, (1024, 768), 4


def _host_headers_found() -> bool:
    """Whether the host compiler finds the decoder's headers."""
    src = "#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n"
    try:
        proc = subprocess.run([os.environ.get("CXX") or "g++", "-E", "-x",
                               "c++", "-", "-o", os.devnull], input=src,
                              capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return False
    return proc.returncode == 0


def _decoder_check(tmp, name_power):
    """Phase 10's decoder: whether ``rpst_torch.native_io`` built here (its
    first error line if not; the phase fails if the compiler finds
    jpeglib.h and png.h and the build failed all the same). Seeded JPEGs
    and PNGs decoded to 512px on the loader's thread count through PIL,
    and where it built through it too, byte for byte against PIL's, each
    timed (warm reads: the files were just written)."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from PIL import Image
    from rpst_torch import native_io
    from rpst_torch.kernels import build

    def pil(path):
        img = Image.open(str(path)).convert("RGB").resize((IMG, IMG),
                                                          Image.BILINEAR)
        return np.asarray(img, dtype=np.float32) / 255.0

    decoders = {"PIL": pil}
    if native_io.available():
        log("10 decoder", "native_io built on this host ("
            f"{build.build_info['imageio']['seconds']:.2f}s of g++ in this "
            "run)")
        decoders = {"native": lambda p: native_io.load_image_native(p, IMG),
                    "PIL": pil}
    elif native_io.reason() == "RPST_NATIVE_IO=0":
        log("10 decoder", "native_io switched off (RPST_NATIVE_IO=0)")
    else:
        why = native_io.reason()
        first = next((ln for ln in why.splitlines() if "error" in ln),
                     why.splitlines()[0] if why else "")
        log("10 decoder", f"native_io did not build on this host: {first}")
        if _host_headers_found():
            raise AssertionError("jpeglib.h and png.h are found but "
                                 f"native_io did not build:\n{why[-3000:]}")
        log("10 decoder", "jpeglib.h / png.h not found by the host "
            "compiler: the loaders decode with PIL (the same bytes)")

    w, h = DECODE_SIZE
    ramp = (np.linspace(0, 1, w)[None, :, None]
            * np.linspace(0.2, 1, h)[:, None, None])
    files = {fmt: [tmp / f"decode_{i:02d}.{ext}" for i in range(DECODE_FILES)]
             for fmt, ext in (("jpeg", "jpg"), ("png", "png"))}

    def write(seed_path):
        seed, path = seed_path
        r = np.random.default_rng(seed)
        img = ((ramp * r.uniform(80, 230, 3)).astype(np.uint8)
               + r.integers(0, 24, (h, w, 3), dtype=np.uint8))
        Image.fromarray(img, "RGB").save(
            path, **({"quality": 90} if path.suffix == ".jpg" else {}))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, enumerate(files["jpeg"] + files["png"])))

    rates = {}
    with ThreadPoolExecutor(DECODE_THREADS) as pool:
        for fmt in ("jpeg", "png"):
            outs = {}
            for label, fn in decoders.items():
                t0 = time.perf_counter()
                outs[label] = list(pool.map(fn, files[fmt]))
                rates[f"{fmt} {label}"] = (len(files[fmt])
                                           / (time.perf_counter() - t0))
            for path, a, b in zip(files[fmt], outs.get("native", outs["PIL"]),
                                  outs["PIL"]):
                if a is None or a.tobytes() != b.tobytes():
                    raise AssertionError(f"native decode of {path.name} "
                                         "differs from PIL's")
    log("10 decoder", f"{2 * DECODE_FILES} files ({DECODE_FILES} JPEG q90 + "
        f"{DECODE_FILES} PNG, {w}x{h}) decoded to {IMG}px"
        + (": native == PIL byte for byte" if "native" in decoders else "")
        + f"; {DECODE_THREADS} threads, img/s "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
        + f" (warm reads; host of the {name_power} machine)")


def _graphcut_check(dev):
    """Phase 10's chain-MRF solvers: the native Viterbi against the port's
    DP (``ops.graphcut.chain_map_labeling``, on the card) on one seeded
    (C = 512, k = 3) Potts problem, to equal energy; the build must
    succeed. ``chain_labeling_native`` returns the labels on the card."""
    import numpy as np
    import torch
    from rpst_torch.ops import graphcut_native as gn
    from rpst_torch.ops.graphcut import chain_map_labeling

    d = np.random.default_rng(0).random((512, 3))
    v = 0.5 * (np.ones((3, 3)) - np.eye(3))
    native = gn.chain_viterbi_cpp(d, v)
    dt, vt = torch.from_numpy(d).to(dev), torch.from_numpy(v).to(dev)
    dp = chain_map_labeling(dt, vt).cpu().numpy()
    e_native, e_dp = gn.chain_energy_cpp(d, v, native), \
        gn.chain_energy_cpp(d, v, dp)
    via = gn.chain_labeling_native(dt, vt)
    if abs(e_native - e_dp) > 1e-9 * abs(e_native) or via.device != dt.device \
            or not np.array_equal(via.cpu().numpy(), native):
        raise AssertionError(f"graph cut: native energy {e_native}, DP "
                             f"{e_dp}, chain_labeling_native on "
                             f"{via.device}")
    log("10 graphcut", f"native Viterbi == the DP on the card at (512, 3): "
        f"energy {e_native:.9f} vs {e_dp:.9f}, "
        f"{int((native != dp).sum())} labels differ (ties); "
        f"chain_labeling_native on {via.device}")


def _trace_kernels(trace_dir):
    """{"B1" | "B2" | "B3": (launches, summed device ms)} of the main
    kernels in the ``*.pt.trace.json`` under ``trace_dir``: B1 and B2's
    shared ``folded_mma_kernel`` told apart by its BWD template argument,
    B3's ``grad_weight_mma`` (the weight packing and B3's reduce left
    out)."""
    import re
    (path,) = Path(trace_dir).glob("*.pt.trace.json")
    out = {k: [0, 0.0] for k in ("B1", "B2", "B3")}
    for ev in json.loads(path.read_text())["traceEvents"]:
        if ev.get("cat") != "kernel":
            continue
        name = ev.get("name", "")
        bwd = re.search(r"folded_mma_kernel<[^,]+,\s*\w+,\s*(\w+)", name)
        key = (("B2" if bwd.group(1) in ("true", "1") else "B1") if bwd
               else "B3" if "grad_weight_mma" in name else None)
        if key:
            out[key][0] += 1
            out[key][1] += ev.get("dur", 0) / 1e3
    return {k: tuple(v) for k, v in out.items()}


def _train_main_path(dev, name_power):
    """Phase 10: train_torch.py on a 512px synthetic corpus, b4 f32 folded:
    3 steps as a subprocess, step 2 traced (``profile_iter`` 2,
    ``profile_steps`` 1), then 2 resumed steps through the same entry
    point in this process, counts reset before and read after; the native
    decoder and graph cut beside it. Returns the resumed run's B1/B2/B3
    launches."""
    import importlib.util
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _decoder_check(tmp, name_power)
        _graphcut_check(dev)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "8", "--size", str(IMG)],
                       check=True, capture_output=True, timeout=300)
        out = tmp / "run"
        cfg_path = tmp / "train.yaml"
        cfg_path.write_text(json.dumps(dict(
            FLAGSHIP, img_size=IMG, exec_strategy="folded", batch_size=4,
            max_iter=4, snapshot_save_iter=2, log_iter=1, num_workers=4,
            profile_iter=2, profile_steps=1,
            content_dir=str(tmp / "corpus" / "content"),
            style_dir=str(tmp / "corpus" / "style"), output=str(out))))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(REPO / "train_torch.py"), "--config",
             str(cfg_path), "--device", "cuda"], capture_output=True,
            text=True, timeout=600, cwd=str(REPO))
        text = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise AssertionError(f"train_torch.py rc {proc.returncode}:\n"
                                 f"{text[-3000:]}")
        child = [tuple(int(v) for v in ln.rsplit(":", 1)[1].split("/"))
                 for ln in text.splitlines() if "B1/B2/B3 launches:" in ln]
        if child != [tuple(3 * n for n in PER_STEP)]:
            raise AssertionError(f"train_torch.py launches {child}, expected "
                                 f"3 steps x {PER_STEP}:\n{text[-3000:]}")
        rates = [ln.split("img/s ")[1].split(",")[0]
                 for ln in text.splitlines() if "img/s" in ln]
        log("10 train", f"train_torch.py b4 512px f32 folded, 3 steps in "
            f"{time.perf_counter() - t0:.1f}s wall (img/s per step "
            f"{rates}); child launches {child[0]}")
        trace_dir = out / "logs" / "trace"
        if f"Wrote device trace for steps 2..2 -> {trace_dir}" not in text:
            raise AssertionError(f"no trace line for step 2:\n{text[-3000:]}")
        traced = _trace_kernels(trace_dir)
        if tuple(traced[k][0] for k in ("B1", "B2", "B3")) != PER_STEP:
            raise AssertionError(f"the step 2 trace holds {traced}, expected "
                                 f"{PER_STEP} B1/B2/B3 launches")
        elapsed = [ln.split("elapsed time: ")[1].split(",")[0]
                   for ln in text.splitlines() if "elapsed time: " in ln]
        log("10 trace", f"step 2's trace holds B1/B2/B3 "
            + ", ".join(f"{k} {n} launches {ms:.3f} ms" for k, (n, ms)
                        in traced.items())
            + f" of device time; step seconds {elapsed} (step 2 traced, its "
            f"start included; step 3 includes the trace's stop and "
            f"export) ({name_power})")

        spec = importlib.util.spec_from_file_location(
            "train_torch", REPO / "train_torch.py")
        driver = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(driver)
        _reset_counts()  # the main path's count starts here
        driver.main(["--config", str(cfg_path), "--device", "cuda", "--set",
                     "resume=true", "max_iter=3"])
        launches = _counts()
        if launches != tuple(2 * n for n in PER_STEP):
            raise AssertionError(f"resumed run launches {launches}, expected "
                                 f"2 steps x {PER_STEP}")
        lines = [json.loads(ln) for ln in
                 (out / "logs" / "metrics.jsonl").read_text().splitlines()]
        steps = [ln["step"] for ln in lines]
        losses = [ln["total_loss"] for ln in lines]
        if steps != [1, 2, 3, 4, 5] or not np.isfinite(losses).all() \
                or any(ln["skipped"] for ln in lines):
            raise AssertionError(f"metrics.jsonl: {lines}")
        ckpts = sorted(int(p.name) for p in (out / "checkpoints").iterdir())
        if ckpts != [2, 3, 5]:
            raise AssertionError(f"checkpoints {ckpts}, expected [2, 3, 5]")
    log("10 train", f"resumed at step 3 for steps 4-5; metrics steps {steps}, "
        f"total_loss {[round(v, 6) for v in losses]}; checkpoints {ckpts}; "
        f"B1/B2/B3 launches {launches} (2 steps x {PER_STEP})")
    return launches


def _train_timing(dev, rng, name_power):
    """Phase 11: the 512px train step (loss, backward, Adam) in img/s at b1
    and b4, f32 and bf16, on three paths, timed with CUDA events."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.train.step import create_train_state, train_step

    cfg = load_config(dict(FLAGSHIP, img_size=IMG, exec_strategy="folded"))
    vgg, _ = build_vgg(cfg, dev)
    for batch in (1, 4):
        c, s = (torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                            np.float32)).to(dev)
                for _ in range(2))
        for dt in ("float32", "bfloat16"):
            for path, strategy, kw in (
                    ("folded B1/B2/B3", "folded", {}),
                    ("folded plain", "folded", {"conv_act": _plain_act}),
                    ("standard", "standard", {})):
                bundle = build_model(cfg.replace(exec_strategy=strategy,
                                                 compute_dtype=dt), dev)
                init_torch_default(bundle.model, cfg.seed)
                state = create_train_state(bundle)
                ms = cuda_ms(lambda: train_step(state, vgg, c, s, **kw),
                             iters=3, warmup=1)
                log("11 train timing", f"{IMG}px b{batch} {dt:8s} {path:16s}: "
                    f"{ms:9.3f} ms/step {batch * 1e3 / ms:8.2f} img/s "
                    f"({name_power})")
                del state, bundle
                torch.cuda.empty_cache()


# ---------------------------------------------------------------- q8

Q8_FIXTURE = REPO / "tests" / "fixtures" / "torch_port_q8.npz"
# the q8 gates: stats at rpst's tests/test_q8.py:213-218; the stylize vs
# rpst at PSNR >= 40 dB and MAE < 1e-3 (a one-ulp AdaIN difference can move
# a decoder requantization by one step); vs folded f32 at rpst's
# tests/test_q8.py:74 PSNR > 30 dB
Q8_STATS_RTOL, Q8_STATS_ATOL = 1e-4, 1e-3
Q8_FIXTURE_PSNR, Q8_FIXTURE_MAE, Q8_VS_FOLDED_PSNR = 40.0, 1e-3, 30.0
Q8_KERNELS = ("B1", "B4", "B7")  # the kernels a q8 stylize launches


def _psnr(got, ref):
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mse = float(np.mean((got - ref) ** 2))
    span = float(ref.max() - ref.min()) or 1.0
    return 10 * np.log10(span * span / max(mse, 1e-30))


def _q8_plan(bundle, fuse_pairs):
    """The scales and B1/B4/B7 launches one q8 stylize derives from the
    bundle's layers (``fast_path_q8.q8_plan``)."""
    import torch
    from rpst_torch.models.fast_path_q8 import q8_plan
    enc, dec = bundle.folded_weights(torch.float32)
    return q8_plan([k for k, _ in enc], [k for k, _ in dec], fuse_pairs)


def _q8_layer(rng, dev, n, h, w, c4, c4o, out_scale=0.05):
    import numpy as np
    import torch
    x = rng.integers(-127, 128, (n, h, w, c4), dtype=np.int8)
    k = rng.integers(-127, 128, (3, 3, c4, c4o), dtype=np.int8)
    sc = np.stack([rng.uniform(2e-6, 6e-6, c4o), rng.normal(0, 0.2, c4o),
                   np.full(c4o, 1.0 / out_scale)]).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, k, sc))


def _bf16_ulps(a, b):
    """Max distance in bf16 steps between two bf16 tensors (bit patterns
    mapped to a monotonic integer order, -0 == +0)."""
    import torch

    def order(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return (order(a) - order(b)).abs().max().item()


def _q8_compare(label, got, ref):
    """int8: identical; bf16: within one ulp; float32 sums: Q8_STATS_*.
    Returns (max abs err, detail)."""
    import torch
    err = (got.float() - ref.float()).abs().max().item()
    if got.dtype == torch.int8:
        ndiff = (got != ref).sum().item()
        if ndiff:
            raise AssertionError(f"{label}: {ndiff} int8 elements differ")
        return err, "int8 identical"
    if got.dtype == torch.bfloat16:
        ulps = _bf16_ulps(got, ref)
        if ulps > 1:
            raise AssertionError(f"{label}: bf16 {ulps} ulps apart")
        return err, f"bf16 within {ulps} ulp"
    if not (torch.isfinite(got).all() and torch.allclose(
            got, ref, rtol=Q8_STATS_RTOL, atol=Q8_STATS_ATOL)):
        raise AssertionError(f"{label}: max abs err {err}")
    return err, f"sums err {err:.3g}"


def _q8_case(rng, dev, n, h, w, c4, c4o, dense, out_scale=0.05):
    """x_q, w_q and scales of a (4C -> 4Co) int8 layer (``_q8_layer``), w_q
    dense random int8 or a quantized ``fold_conv_kernel`` of a random image
    kernel: 36 of its 144 blocks non-zero, the blocks B4 and B7 take."""
    import torch
    from rpst_torch.ops.folded import fold_conv_kernel
    from rpst_torch.ops.folded_conv_q8 import quantize_weights
    x, k, sc = _q8_layer(rng, dev, n, h, w, c4, c4o, out_scale)
    if not dense:
        k3 = torch.from_numpy(rng.standard_normal(
            (3, 3, c4 // 4, c4o // 4)).astype("float32"))
        k = quantize_weights(fold_conv_kernel(k3))[0].to(dev).contiguous()
    return x, k, sc


# B4 (N, H, W, 4C, 4Co): the path's shape, a ragged one, and the edges of
# the tensor-core tilings: N = 3 and W = 33; H = 2, W = 37, 4C = 16 (a
# 32-channel K step spans the four input blocks) and 4Co = 132 (contiguous
# channels, two channel tiles); 4Co = 4 (the narrow tiling)
B4_CASES = (("path (1,256,256,128->128)", (1, 256, 256, 128, 128)),
            ("ragged (2,38,22,128->128)", (2, 38, 22, 128, 128)),
            ("edge (3,10,33,128->128)", (3, 10, 33, 128, 128)),
            ("edge (1,2,37,16->132)", (1, 2, 37, 16, 132)),
            ("edge (2,9,17,128->4)", (2, 9, 17, 128, 4)))


def _q8_kernels(dev, name_power):
    """Phase 12: B4 vs its plain version (float64 conv, exact integer sums)
    at the path's shape and the tilings' edges, with a quantized fold (36
    listed blocks) and a dense kernel, and B7's six outputs equal to two B4
    launches; each timed against its plain version at the path's shape,
    beside B1 bf16 there (the rival q8 must beat). Returns the kernels JSON
    numbers (B4 and B7 with folded kernels)."""
    import numpy as np
    import torch
    from rpst_torch.ops.folded import fold_bias, fold_conv_kernel
    from rpst_torch.ops.folded_conv import fused_folded_conv
    from rpst_torch.ops.folded_conv2_q8 import (fused_folded_conv2_q8,
                                                fused_folded_conv2_q8_plain)
    from rpst_torch.ops.folded_conv_q8 import (fused_folded_conv_q8,
                                               fused_folded_conv_q8_plain)
    rng = np.random.default_rng(2)
    out = {"B4": {"err": 0.0}, "B7": {"err": 0.0}}
    with torch.inference_mode():
        for label, shape in B4_CASES:
            for dense in (False, True):
                kind = "dense" if dense else "folded"
                x, k, sc = _q8_case(rng, dev, *shape, dense)
                msg = []
                for out_int8 in (True, False):
                    for stats in (False, True):
                        got = fused_folded_conv_q8(x, k, sc, out_int8, stats)
                        torch.cuda.synchronize()
                        ref = fused_folded_conv_q8_plain(x, k, sc, out_int8,
                                                         stats)
                        got, ref = ((got, ref) if stats
                                    else ((got,), (ref,)))
                        for i, (g, r) in enumerate(zip(got, ref)):
                            e, d = _q8_compare(
                                f"B4 {label} {kind} out_int8={out_int8} "
                                f"stats={stats} [{i}]", g, r)
                            out["B4"]["err"] = max(out["B4"]["err"], e)
                            msg.append(d)
                log("12 q8 kernels", f"B4 {label} {kind}, 4 modes: "
                    f"{'; '.join(sorted(set(msg)))}")
        for label, shape in B4_CASES[:2]:
            n, h, w, c4, _ = shape
            for dense in (False, True):
                x, k, sc = _q8_case(rng, dev, *shape, dense)
                _, k2, sc2 = _q8_case(rng, dev, n, h, w, 128, 128, dense,
                                      0.02)
                for out_int8 in (True, False):
                    got = fused_folded_conv2_q8(x, k, sc, k2, sc2, out_int8,
                                                True)
                    y1, s11, s12 = fused_folded_conv_q8(x, k, sc, True, True)
                    y2, s21, s22 = fused_folded_conv_q8(y1, k2, sc2,
                                                        out_int8, True)
                    torch.cuda.synchronize()
                    for i, (g, r) in enumerate(zip(
                            got, (y1, y2, s11, s12, s21, s22))):
                        if not torch.equal(g, r):
                            raise AssertionError(
                                f"B7 {label} out_int8={out_int8} [{i}]: "
                                f"{(g != r).sum().item()} elements differ "
                                "from two B4 launches")
                    ref = fused_folded_conv2_q8_plain(x, k, sc, k2, sc2,
                                                      out_int8, True)
                    for i, (g, r) in enumerate(zip(got, ref)):
                        e, _ = _q8_compare(f"B7 {label} vs plain [{i}]", g, r)
                        out["B7"]["err"] = max(out["B7"]["err"], e)
                    log("12 q8 kernels", f"B7 {label} "
                        f"{'dense' if dense else 'folded'} out_int8="
                        f"{out_int8}: six outputs equal to two B4 launches")
        t = {}
        for dense in (False, True):
            kind = "dense" if dense else "folded"
            x, k, sc = _q8_case(rng, dev, 1, 256, 256, 128, 128, dense)
            _, k2, sc2 = _q8_case(rng, dev, 1, 256, 256, 128, 128, dense,
                                  0.02)
            t[kind] = {
                "B4": cuda_ms(lambda: fused_folded_conv_q8(x, k, sc, True,
                                                           True)),
                "B4 plain": cuda_ms(lambda: fused_folded_conv_q8_plain(
                    x, k, sc, True, True), iters=5, warmup=1),
                "B4 bf16": cuda_ms(lambda: fused_folded_conv_q8(x, k, sc,
                                                                False)),
                "B7": cuda_ms(lambda: fused_folded_conv2_q8(
                    x, k, sc, k2, sc2, True, True)),
                "B7 plain": cuda_ms(lambda: fused_folded_conv2_q8_plain(
                    x, k, sc, k2, sc2, True, True), iters=5, warmup=1),
                "2xB4": cuda_ms(lambda: fused_folded_conv_q8(
                    fused_folded_conv_q8(x, k, sc, True, True)[0], k2, sc2,
                    True, True))}
        # the rival: B1 in bfloat16 on the same layer's float form
        g = torch.Generator().manual_seed(3)
        xb = torch.randn(1, 256, 256, 128, generator=g).to(dev, torch.bfloat16)
        kb = fold_conv_kernel(torch.randn(3, 3, 32, 32, generator=g)
                              * (9 * 32) ** -0.5).to(dev, torch.bfloat16)
        bb = fold_bias(torch.randn(32, generator=g) * 0.1).to(dev,
                                                              torch.bfloat16)
        t["B1 bf16"] = cuda_ms(lambda: fused_folded_conv(
            xb, kb.contiguous(), bb, 0.2))
    bnd = {kind: (q8_bound(1, 256, 256, 128, 128, kind == "folded")[0],
                  q8_bound(1, 256, 256, 128, 128, kind == "folded",
                           layers=2)[0]) for kind in t if kind != "B1 bf16"}
    for kind in ("folded", "dense"):
        tk = t[kind]
        log("12 q8 kernels", f"(1,256,256,128->128) {kind} kernel, ms: B4 "
            f"int8+stats {tk['B4']:.4f} vs plain {tk['B4 plain']:.4f} "
            f"(bound {bnd[kind][0]:.4f}, {100 * bnd[kind][0] / tk['B4']:.1f}"
            f"%); B4 bf16 {tk['B4 bf16']:.4f}; B7 pair {tk['B7']:.4f} vs "
            f"plain {tk['B7 plain']:.4f} vs two B4 {tk['2xB4']:.4f} (bound "
            f"{bnd[kind][1]:.4f}); B1 bf16 {t['B1 bf16']:.4f} "
            f"({name_power})")
    out["B4"].update(ms=t["folded"]["B4"], plain_ms=t["folded"]["B4 plain"])
    out["B7"].update(ms=t["folded"]["B7"], plain_ms=t["folded"]["B7 plain"])
    return out


def _q8_fixture(dev):
    """Phase 13: the q8 stylize on the card with rpst's act scales vs
    rpst's JAX output, f32 and bf16; exact launches; fuse_pairs bit-equal."""
    import numpy as np
    import torch
    from rpst_torch.bridge import load_weights
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    with np.load(Q8_FIXTURE) as fx:
        fx = {k: fx[k] for k in ("content", "style", "act_scales", "out_f32",
                                 "out_bf16")}
    bundle = build_model(load_config(dict(
        FLAGSHIP, img_size=fx["content"].shape[1])), dev)
    bundle.load_state_dict(load_weights(Q8_FIXTURE))
    c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
    scales = {"act_scales": fx["act_scales"]}
    outs, msg = {}, []
    for fuse in (False, True):
        plan = _q8_plan(bundle, fuse)
        if plan["scales"] != len(fx["act_scales"]):
            raise AssertionError(f"plan {plan} vs {len(fx['act_scales'])} "
                                 "fixture scales")
        want = {k: plan[k] for k in Q8_KERNELS}
        for dt, key in ((torch.float32, "out_f32"),
                        (torch.bfloat16, "out_bf16")):
            _reset_counts()
            y = bundle.stylize_q8(c, s, scales, dtype=dt, fuse_pairs=fuse)
            torch.cuda.synchronize()
            if _counts(Q8_KERNELS) != want:
                raise AssertionError(f"q8 fixture launches {_counts(Q8_KERNELS)}, "
                                     f"expected {want}")
            got = y.cpu().numpy()
            psnr, mae = _psnr(got, fx[key]), float(
                np.abs(got - fx[key]).mean())
            if not (np.isfinite(got).all() and psnr >= Q8_FIXTURE_PSNR
                    and mae < Q8_FIXTURE_MAE):
                raise AssertionError(f"q8 fixture {key} fuse_pairs={fuse}: "
                                     f"PSNR {psnr} dB, MAE {mae}")
            outs[(fuse, key)] = y
            if not fuse:
                msg.append(f"{key} PSNR {psnr:.2f} dB, MAE {mae:.3g}, max "
                           f"{float(np.abs(got - fx[key]).max()):.3g}")
        msg.append(f"fuse_pairs={fuse} launches {want}")
    for key in ("out_f32", "out_bf16"):
        if not torch.equal(outs[(False, key)], outs[(True, key)]):
            raise AssertionError(f"q8 fixture {key}: fuse_pairs changed it")
    log("13 q8 fixture", f"64px rp5 h32 vs rpst JAX (interpret): "
        f"{'; '.join(msg)}; fuse_pairs bit-equal")


def _q8_parity(dev, rng):
    """Phase 14: 512px b2 q8 (bf16, as served) vs the port's folded f32
    path, and fuse_pairs bit-equal."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    cfg = load_config(dict(FLAGSHIP, img_size=IMG, exec_strategy="folded"))
    bundle = build_model(cfg, dev)
    init_torch_default(bundle.model, cfg.seed)
    c, s = (torch.from_numpy(rng.random((2, IMG, IMG, 3),
                                        np.float32)).to(dev)
            for _ in range(2))
    scales = bundle.calibrate_q8(c, s)
    q8 = bundle.stylize_q8(c, s, scales, fuse_pairs=False)
    pairs = bundle.stylize_q8(c, s, scales, fuse_pairs=True)
    folded = bundle.stylize(c, s, folded=True)
    torch.cuda.synchronize()
    psnr = _psnr(q8.cpu().numpy(), folded.cpu().numpy())
    if not (torch.isfinite(q8).all() and psnr > Q8_VS_FOLDED_PSNR):
        raise AssertionError(f"512px q8 vs folded f32: PSNR {psnr} dB")
    if not torch.equal(q8, pairs):
        raise AssertionError("512px fuse_pairs output differs from unfused")
    log("14 q8 parity", f"512px b2 q8 (bf16) vs folded f32: PSNR {psnr:.2f} "
        f"dB (bound > {Q8_VS_FOLDED_PSNR}); fuse_pairs bit-equal; "
        f"{len(scales['act_scales'])} act scales")


def _q8_serve(dev, rng):
    """Phase 15: the int8 main path through the user's entry points, unfused
    and with fuse_pairs, counts reset before and read after each; then
    serve_torch.py --mode q8. Returns the main path's B1/B4/B7 launches."""
    import numpy as np
    import torch
    from PIL import Image
    from rpst_torch.config import load_config
    from rpst_torch.data import load_image
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.policy import FUSE_PAIRS
    from rpst_torch.serving import (DynamicBatcher, calibrate_scales,
                                    make_run_impl, resolve_mode)
    launches = {"B1": 0, "B4": 0, "B7": 0}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for sub in ("content", "style"):
            (tmp / sub).mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                            "RGB").save(tmp / "content" / f"c{i}.png")
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                        "RGB").save(tmp / "style" / "s.png")
        cfg_path = tmp / "cfg.yaml"
        cfg_path.write_text(json.dumps(dict(FLAGSHIP, img_size=IMG)))
        cfg = load_config(str(cfg_path), {"exec_strategy": "folded"})
        bundle = build_model(cfg, dev)
        init_torch_default(bundle.model, cfg.seed)
        mode = resolve_mode(bundle, "q8", batch=4)
        if mode != "q8":
            raise AssertionError(f"resolve_mode q8 gave {mode}")
        imgs = [load_image(tmp / "content" / f"c{i}.png", IMG)
                for i in range(8)]
        style_img = load_image(tmp / "style" / "s.png", IMG)
        calib = torch.from_numpy(np.stack(imgs[:4])).to(dev)
        scales = calibrate_scales(bundle, calib, torch.from_numpy(
            style_img)[None].to(dev).expand_as(calib).contiguous())
        for fuse in (False, True):
            plan = _q8_plan(bundle, fuse)
            if len(scales["act_scales"]) != plan["scales"]:
                raise AssertionError(f"{len(scales['act_scales'])} scales, "
                                     f"plan {plan}")
            run = make_run_impl(bundle, mode, scales, fuse_pairs=fuse)
            batcher = DynamicBatcher(run, batch_size=4, max_wait_ms=50.0,
                                     device=dev)
            _reset_counts()  # this main path's count starts here
            try:
                outs = [f.result(timeout=300) for f in
                        [batcher.submit(im, style_img) for im in imgs]]
            finally:
                batcher.close()
            got = _counts(Q8_KERNELS)
            batches = batcher.stats()["batches"]
            want = {k: batches * plan[k] for k in Q8_KERNELS}
            if got != want:
                raise AssertionError(f"q8 main path fuse_pairs={fuse}: "
                                     f"launches {got}, expected {want} "
                                     f"({batches} batches x {plan})")
            for o in outs:
                if o.shape != (IMG, IMG, 3) or not np.isfinite(o).all():
                    raise AssertionError(f"q8 main path output {o.shape}")
            for k in launches:
                launches[k] += got[k]
            log("15 q8 serve", f"8 requests via DynamicBatcher(b4), "
                f"fuse_pairs={fuse}: {batcher.stats()}, launches {got} "
                f"({batches} batches x {plan})")

        swept = tmp / "swept"
        t0 = time.perf_counter()
        text = _serve_cli(
            ["--config", str(cfg_path), "--content", str(tmp / "content"),
             "--style", str(tmp / "style" / "s.png"), "--out", str(swept),
             "--mode", "q8", "--batch", "4", "--device", "cuda"])
        plan = _q8_plan(bundle, FUSE_PAIRS)
        child = {k: _logged_count(text, k) for k in Q8_KERNELS}
        want = {k: 2 * plan[k] for k in Q8_KERNELS}  # 2 batches
        # + calibration: one bf16 folded forward, B1 on every layer
        enc, dec = bundle.folded_weights(torch.float32)
        want["B1"] += 2 * len(enc) + len(dec)
        pngs = sorted(swept.glob("*.png"))
        if (len(pngs) != 8 or child != want or not child["B4"] > 0
                or f"Calibrated {plan['scales']} layer scales" not in text):
            raise AssertionError(f"serve_torch q8: {len(pngs)} PNGs, child "
                                 f"launches {child} vs {want}:\n"
                                 f"{text[-3000:]}")
        rate = [ln for ln in text.splitlines() if "Stylized" in ln]
        log("15 q8 serve", f"serve_torch.py --mode q8: 8 PNGs, 'Calibrated "
            f"{plan['scales']} layer scales', child launches {child}, "
            f"{time.perf_counter() - t0:.1f}s wall; "
            f"{rate[-1].split(' - ')[-1] if rate else ''}")
    return launches


def _logged_count(text, label):
    """The count serve_torch.py logs as '<label> <kernel> launches: N'."""
    counts = [int(ln.rsplit(":", 1)[1]) for ln in text.splitlines()
              if f" - {label} " in ln and " launches:" in ln]
    return counts[-1] if counts else None


def _q8_timing(dev, rng, name_power, rows):
    """Phase 16: 512px q8 stylize b1/b8 (bf16, as served), with B4 alone
    and with B7 pairs, beside folded B1 and standard in bfloat16, all four
    once in this call (the A/B of policy.FUSE_PAIRS and Q8_AUTO_BATCHES
    took both orders; one keeps the script inside its time limit), CUDA
    events; then phase 7's rows."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.models.fast_path import stylize_multi_adain_folded
    from rpst_torch.nn.blocks import init_torch_default
    cfg = load_config(dict(FLAGSHIP, img_size=IMG, exec_strategy="folded"))
    bundle = build_model(cfg, dev)
    init_torch_default(bundle.model, cfg.seed)
    std = build_model(cfg.replace(exec_strategy="standard"), dev)
    std.load_state_dict(bundle.model.state_dict())
    bf = torch.bfloat16
    w = bundle.folded_weights(bf)
    with torch.inference_mode():
        for batch in (1, 8):
            c, s = (torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                                np.float32)).to(dev)
                    for _ in range(2))
            scales = bundle.calibrate_q8(c, s)
            paths = {
                "q8 B4": lambda: bundle.stylize_q8(c, s, scales,
                                                   fuse_pairs=False),
                "q8 B7 pairs": lambda: bundle.stylize_q8(c, s, scales,
                                                         fuse_pairs=True),
                "folded B1": lambda: stylize_multi_adain_folded(
                    w, c, s, dtype=bf),
                "standard": lambda: _standard(std, c, s, bf)}
            for path in paths:  # one order: the script's time limit
                ms = cuda_ms(paths[path], iters=5, warmup=2)
                log("16 q8 timing", f"512px b{batch} bfloat16 {path:12s}: "
                    f"{ms:8.3f} ms  {batch * 1e3 / ms:8.2f} img/s  "
                    f"({name_power})")
            for b, dt, path, ms in rows:
                if b == batch and path != "folded plain":
                    log("16 q8 timing", f"512px b{batch} {dt:8s} {path:12s}: "
                        f"{ms:8.3f} ms  {batch * 1e3 / ms:8.2f} img/s  "
                        f"(phase 7, {name_power})")


# ---------------------------------------------------------------- B5

WIDE = dict(rp_blocks=5, hidden_dim=32, seed=0)
ADAIN_YAML = REPO / "configs" / "train_deeper_rp_adain.yaml"  # hidden 16
# every shape the paths give B5, (label, (N, H, W, C, Co), pad): the four
# eligible layers of a 512px adain / wct stylize at hidden 32 (encoder on
# the 2N batch, checked at 2N = 2; decoder at N = 2; seg_adain's are
# adain's), the six of the int8 VGG targets at 512px (conv_6..8 share one
# shape), the six shapes a 512px SANet q8 stylize adds at batch 1 (the
# deeper VGG stages on the 2N batch, the mirror decoder's conv0 .. conv5),
# and the three a b1 mrf / spade stylize adds (the encoder tails, one pass
# per encoder, and mrf's decoder head on the 1024-channel concat)
B5_SHAPES = (
    ("adain enc 128->256", (2, 512, 512, 128, 256), "zero"),
    ("adain enc 256->512", (2, 512, 512, 256, 512), "zero"),
    ("adain dec 512->256", (2, 512, 512, 512, 256), "zero"),
    ("adain dec 256->128", (2, 512, 512, 256, 128), "zero"),
    ("VGG conv_4 128->128", (2, 256, 256, 128, 128), "reflect"),
    ("VGG conv_5 128->256", (2, 128, 128, 128, 256), "reflect"),
    ("VGG conv_6..8 256->256", (2, 128, 128, 256, 256), "reflect"),
    ("VGG conv_9 256->512", (2, 64, 64, 256, 512), "reflect"),
    ("VGG conv_10..12 512->512", (2, 64, 64, 512, 512), "reflect"),
    ("VGG conv_13 512->512", (2, 32, 32, 512, 512), "reflect"),
    ("mirror conv0 512->256", (1, 64, 64, 512, 256), "reflect"),
    ("mirror conv1..3 256->256", (1, 128, 128, 256, 256), "reflect"),
    ("mirror conv4 256->128", (1, 128, 128, 256, 128), "reflect"),
    ("mirror conv5 128->128", (1, 256, 256, 128, 128), "reflect"),
    ("mrf/spade enc 128->256", (1, 512, 512, 128, 256), "zero"),
    ("mrf/spade enc 256->512", (1, 512, 512, 256, 512), "zero"),
    ("mrf dec 1024->512", (1, 512, 512, 1024, 512), "zero"))
B5_WIDEST = "adain enc 256->512"
# (N, H, W, C, Co) at the edges of B5's tilings (16 pixel columns x 8 rows,
# 64 or 128 output channels, 32 input channels a step): the k tail at C = 4,
# 36, 48; Co = 4 and 132; H or W = 2; W = 33, 37
B5_EDGES = ((1, 2, 2, 4, 4), (1, 2, 37, 48, 4), (2, 9, 2, 4, 132),
            (1, 5, 17, 36, 68), (3, 16, 33, 128, 192))
WIDE_F32_TOL, WCT_F32_TOL = 1e-4, 1e-3  # wct: two 512x512 eigh in float32
Q8T_LOSS_RTOL = 5e-3  # tests/test_torch_q8_targets.py states the reason


def _b5_layer(rng, dev, n, h, w, c, co):
    import numpy as np
    import torch
    x = rng.integers(-127, 128, (n, h, w, c), dtype=np.int8)
    k = rng.integers(-127, 128, (3, 3, c, co), dtype=np.int8)
    sc = np.stack([rng.uniform(2e-6, 6e-6, co) * (128 / c),
                   rng.normal(0, 0.2, co),
                   rng.uniform(10.0, 40.0, co)]).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, k, sc))


def _b5_kernels(dev, name_power):
    """Phase 17: B5 and its bf16 mode against their plain versions, and
    B5's time per path shape beside its plain version, the one library call
    and its bound. Returns the kernels JSON numbers (at B5_WIDEST)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from rpst_torch.ops.conv2d_q8 import (fused_conv2d_bf16,
                                          fused_conv2d_bf16_plain,
                                          fused_conv2d_q8,
                                          fused_conv2d_q8_plain,
                                          pack_conv2d_weights)
    rng = np.random.default_rng(5)
    out = {"err": 0.0}
    with torch.inference_mode():
        # the edges of the tilings, both pads, both outputs, bits compared
        for shape in B5_EDGES:
            x, k, sc = _b5_layer(rng, dev, *shape)
            for pad in ("reflect", "zero"):
                for out_int8 in (True, False):
                    got = fused_conv2d_q8(x, k, sc, out_int8, 0.2, pad)
                    torch.cuda.synchronize()
                    ref = fused_conv2d_q8_plain(x, k, sc, out_int8, 0.2, pad)
                    e, _ = _q8_compare(f"B5 edge {shape} {pad} out_int8="
                                       f"{out_int8}", got, ref)
                    if not out_int8 and not torch.equal(
                            got.view(torch.int16), ref.view(torch.int16)):
                        raise AssertionError(f"B5 edge {shape} {pad}: bf16 "
                                             "bits differ")
                    out["err"] = max(out["err"], e)
            log("17 B5 kernels", f"edge {shape}: int8 identical, bf16 bits "
                "equal, both pads")
        # every mode at an odd shape: H != W, W no multiple of the 16-wide
        # tile, Co past one 128-channel block
        x, k, sc = _b5_layer(rng, dev, 2, 13, 37, 36, 132)
        for alpha in (0.0, 0.2, 1.0):
            for pad in ("reflect", "zero"):
                msg = []
                for out_int8 in (True, False):
                    got = fused_conv2d_q8(x, k, sc, out_int8, alpha, pad)
                    torch.cuda.synchronize()
                    ref = fused_conv2d_q8_plain(x, k, sc, out_int8, alpha,
                                                pad)
                    e, d = _q8_compare(f"B5 odd alpha={alpha} {pad} "
                                       f"out_int8={out_int8}", got, ref)
                    if not out_int8:
                        d += (", bits equal (-0.0 kept)" if torch.equal(
                            got.view(torch.int16), ref.view(torch.int16))
                            else ", bits differ")
                    out["err"] = max(out["err"], e)
                    msg.append(d)
                log("17 B5 kernels", f"odd (2,13,37,36->132) alpha={alpha} "
                    f"{pad}: {'; '.join(msg)}")
        # the paths' shapes, relu (alpha = 0), both outputs; then timed
        for label, shape, pad in B5_SHAPES:
            n, h, w, c, co = shape
            x, k, sc = _b5_layer(rng, dev, *shape)
            msg = []
            for out_int8 in (True, False):
                got = fused_conv2d_q8(x, k, sc, out_int8, 0.0, pad)
                torch.cuda.synchronize()
                ref = fused_conv2d_q8_plain(x, k, sc, out_int8, 0.0, pad)
                e, d = _q8_compare(f"B5 {label} out_int8={out_int8}", got,
                                   ref)
                out["err"] = max(out["err"], e)
                msg.append(d)
                del got, ref
            # as the paths call it: the layer keeps its packed weights
            kp = pack_conv2d_weights(k)
            ms = cuda_ms(lambda: fused_conv2d_q8(x, k, sc, True, 0.0, pad,
                                                 w_packed=kp), iters=10)
            plain = cuda_ms(lambda: fused_conv2d_q8_plain(x, k, sc, True, 0.0,
                                                          pad),
                            iters=3, warmup=1)
            # the one library call: conv + bias in bfloat16 on the
            # dequantized values, channels-last as B5 reads them (no
            # activation, no requantization; reflect pads outside the call)
            xd = (x.float() * 0.01).to(torch.bfloat16).permute(0, 3, 1, 2)
            wd = (k.float() * 0.01).to(torch.bfloat16).permute(3, 2, 0, 1) \
                .contiguous(memory_format=torch.channels_last)
            bd = sc[1].to(torch.bfloat16)
            lib = cuda_ms(lambda: F.conv2d(xd, wd, bd, padding=1), iters=10)
            b_ms, b_by = conv_bound(n, h, w, c, co, "int8", 1, [1],
                                    extra_bytes=3 * co * 4)
            log("17 B5 kernels", f"{label} {shape} {pad}: {'; '.join(msg)}; "
                f"B5 {ms:.4f} ms vs plain {plain:.4f}, F.conv2d bf16 "
                f"{lib:.4f}; bound {b_ms:.4f} ms by {b_by} "
                f"({100 * b_ms / ms:.1f}% of it reached; {name_power})")
            if label == B5_WIDEST:
                out.update(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=b_ms, bound_by=b_by)
            del x, k, kp, sc, xd, wd
            torch.cuda.empty_cache()
        # the bf16 mode, at the widest VGG shape and an odd one
        g = torch.Generator().manual_seed(6)
        for shape in ((2, 128, 128, 256, 256), (2, 9, 19, 40, 72)):
            n, h, w, c, co = shape
            x = torch.randn(n, h, w, c, generator=g).to(dev)
            k = (torch.randn(3, 3, c, co, generator=g) * (9 * c) ** -0.5).to(
                dev)
            b = torch.randn(co, generator=g).to(dev)
            for pad in ("reflect", "zero"):
                for alpha in (0.0, 0.2, 1.0):
                    got = fused_conv2d_bf16(x, k, b, alpha, pad)
                    torch.cuda.synchronize()
                    err, _ = check_close(
                        f"B5 bf16 mode {shape} {pad} alpha={alpha}", got,
                        fused_conv2d_bf16_plain(x, k, b, alpha, pad),
                        BF16_TOL)
                    log("17 B5 kernels", f"bf16 mode {shape} {pad} "
                        f"alpha={alpha}: max abs err {err:.3g} (tol "
                        f"{BF16_TOL})")
            if c == 256:
                xb, kb = x.to(torch.bfloat16), k.to(torch.bfloat16)
                xd = xb.permute(0, 3, 1, 2)
                wd = kb.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                bd = b.to(torch.bfloat16)
                t = (cuda_ms(lambda: fused_conv2d_bf16(xb, kb, b, 0.0)),
                     cuda_ms(lambda: fused_conv2d_bf16_plain(x, k, b, 0.0)),
                     cuda_ms(lambda: F.conv2d(F.pad(xd, (1, 1, 1, 1),
                                                    mode="reflect"), wd, bd)))
                b_ms, b_by = conv_bound(n, h, w, c, co, "bf16", 2, [2])
                log("17 B5 kernels", f"bf16 mode {shape}: {t[0]:.4f} ms "
                    f"(weights repacked per call) vs plain {t[1]:.4f}, "
                    f"reflect pad + F.conv2d bf16 {t[2]:.4f}; bound "
                    f"{b_ms:.4f} ms by {b_by} ({100 * b_ms / t[0]:.1f}% of "
                    f"it reached; {name_power})")
    return out


def _rpseq_bundle(network, dev, size, seed=0, **over):
    """A bundle of adain / wct at full width with the weights that
    ``rpseq_weights_from_seed(seed)`` draws (the fixtures' weights)."""
    from rpst_torch.bridge import from_flax_params, rpseq_weights_from_seed
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    bundle = build_model(load_config(dict(WIDE, network=network,
                                          img_size=size, **over)), dev)
    bundle.load_state_dict(from_flax_params(rpseq_weights_from_seed(
        seed, WIDE["rp_blocks"], WIDE["hidden_dim"])))
    return bundle


def _wide_fixtures(dev):
    """Phase 18: adain and wct on the card vs rpst's JAX outputs."""
    import numpy as np
    import torch
    from rpst_torch.models.fast_path_q8_std import std_q8_plan
    for network, tol in (("adain", WIDE_F32_TOL), ("wct", WCT_F32_TOL)):
        with np.load(REPO / "tests" / "fixtures" /
                     f"torch_port_{network}.npz") as npz:
            fx = {k: npz[k] for k in npz.files}
        bundle = _rpseq_bundle(network, dev, fx["content"].shape[1],
                               int(fx["weights_seed"]))
        c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
        plan = std_q8_plan(*bundle.std_weights(torch.float32))
        if plan != {"scales": len(fx["act_scales"]), "B5": 4}:
            raise AssertionError(f"{network} plan {plan}")
        _reset_counts()
        out = bundle.stylize(c, s)
        torch.cuda.synchronize()
        err, mae = check_close(f"{network} fixture standard f32", out,
                               torch.from_numpy(fx["out_f32"]).to(dev), tol)
        msg = [f"standard f32 max abs err {err:.3g}, MAE {mae:.3g} (tol "
               f"{tol})"]
        scales = {"act_scales": fx["act_scales"]}
        # float32 at phase 13's PSNR gate; its MAE bound doubles (the CPU
        # rehearsal read 8e-4 to 9e-4): the narrow float32 layers' sums
        # differ in the last bit between conv libraries, which moves a few
        # first-quantization boundaries, and four int8 layers of up to 512
        # channels (and wct's eigendecompositions) spread that. In bfloat16
        # the six narrow layers round at different places in the two
        # frameworks: rpst's own q8-vs-float gate (30 dB) and the bf16
        # serving MAE bound (1e-2)
        for dt, key, min_psnr, max_mae in (
                (torch.float32, "out_q8_f32", Q8_FIXTURE_PSNR,
                 2 * Q8_FIXTURE_MAE),
                (torch.bfloat16, "out_q8_bf16", Q8_VS_FOLDED_PSNR, 1e-2)):
            _reset_counts()
            got = bundle.stylize_q8(c, s, scales, dtype=dt).cpu().numpy()
            n_b5 = _counters()["B5"].launches
            psnr = _psnr(got, fx[key])
            mae = float(np.abs(got - fx[key]).mean())
            if not (np.isfinite(got).all() and psnr >= min_psnr
                    and mae < max_mae and n_b5 == plan["B5"]):
                raise AssertionError(f"{network} fixture {key}: PSNR {psnr} "
                                     f"dB, MAE {mae}, {n_b5} B5 launches")
            msg.append(f"{key} PSNR {psnr:.2f} dB, MAE {mae:.3g}")
        own = bundle.calibrate_q8(c, s)["act_scales"]
        if not np.allclose(own, fx["act_scales"], rtol=2e-2):
            raise AssertionError(f"{network} calibration {own} vs rpst "
                                 f"{fx['act_scales']}")
        log("18 wide fixtures", f"{network} 64px rp5 h32 b2 vs rpst JAX: "
            f"{'; '.join(msg)}; {plan['B5']} B5 launches per q8 stylize; "
            f"{plan['scales']} scales within 2e-2 of rpst's")


def _q8_targets_fixture(dev):
    """Phase 19: the int8 VGG targets and their loss on the card vs rpst."""
    import numpy as np
    import torch
    from rpst_torch.bridge import vgg_from_flax, vgg_weights_from_seed
    from rpst_torch.models.fast_path_q8_std import (calibrate_vgg_targets_q8,
                                                    vgg_q8_plan,
                                                    vgg_target_taps_q8)
    from rpst_torch.nn.vgg import VGG19Encoder
    from rpst_torch.nn.vgg_folded import perceptual_rp_losses_q8targets
    from rpst_torch.ops.stats import calc_mean_std
    with np.load(REPO / "tests" / "fixtures" /
                 "torch_port_q8_targets.npz") as npz:
        fx = {k: npz[k] for k in npz.files}
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]))))
    vgg = vgg.to(dev)
    c, s, x = (torch.from_numpy(fx[k]).to(dev)
               for k in ("content", "style", "stylized"))
    scales = {"act_scales": fx["act_scales"]}
    plan = vgg_q8_plan(vgg)
    if plan != {"scales": len(fx["act_scales"]), "B5": B5_PER_TARGET_PASS}:
        raise AssertionError(f"VGG q8 plan {plan}")
    _reset_counts()
    taps = vgg_target_taps_q8(vgg, scales, torch.cat([s, c]), torch.float32)
    torch.cuda.synchronize()
    if _counters()["B5"].launches != B5_PER_TARGET_PASS:
        raise AssertionError(f"{_counters()['B5'].launches} B5 launches for "
                             "one target pass")
    msg = []
    for i, t in enumerate(taps):
        if i < 2:
            # relu1_1, relu2_1 come from float convs: their statistics
            m, sd = calc_mean_std(t.float())
            for name, got in (("mean", m), ("std", sd)):
                ref = torch.from_numpy(fx[f"tap_{name}_{i}"]).to(dev)
                if not torch.allclose(got[:, 0, 0, :], ref, rtol=1e-3,
                                      atol=1e-4 * float(ref.abs().max())):
                    raise AssertionError(f"tap {i} {name}: rpst's differs")
        else:
            # relu3_1, relu4_1 pass the int8 chain: the whole tap
            got, ref = t.cpu().numpy(), fx[f"tap_{i}"]
            psnr = _psnr(got, ref)
            if not (got.shape == ref.shape and np.isfinite(got).all()
                    and psnr >= Q8_FIXTURE_PSNR):
                raise AssertionError(f"tap {i}: PSNR {psnr} dB vs rpst")
            msg.append(f"relu{i + 1}_1 PSNR {psnr:.2f} dB")
    parts, total = perceptual_rp_losses_q8targets(
        vgg, scales, x, s, c, 1.0, 2.0, dtype=torch.float32)
    got = {"style_loss": float(parts["style_loss"]),
           "content_loss": float(parts["content_loss"]),
           "total_loss": float(total)}
    for k, v in got.items():
        if not abs(v - float(fx[k])) <= Q8T_LOSS_RTOL * abs(float(fx[k])):
            raise AssertionError(f"q8-targets {k}: {v} vs rpst {fx[k]}")
    own = calibrate_vgg_targets_q8(vgg, c, s)["act_scales"]
    if not np.allclose(own, fx["act_scales"], rtol=2e-2):
        raise AssertionError(f"VGG target calibration {own} vs rpst "
                             f"{fx['act_scales']}")
    log("19 q8 targets fixture", f"64px b4 f32 vs rpst JAX (interpret): "
        f"{'; '.join(msg)}; relu1_1/relu2_1 statistics within 1e-3; loss parts "
        f"{ {k: round(v, 7) for k, v in got.items()} } vs "
        f"{ {k: round(float(fx[k]), 7) for k in got} } (rtol "
        f"{Q8T_LOSS_RTOL}); {B5_PER_TARGET_PASS} B5 launches, "
        f"{plan['scales']} scales within 2e-2 of rpst's")


def _serve_child(cfg_path, tmp, out_name, mode, extra=()):
    """serve_torch.py (``_serve_cli``) on tmp's 8 PNGs at batch 4; returns
    its log text and PNG count."""
    text = _serve_cli(
        ["--config", str(cfg_path), "--content", str(tmp / "content"),
         "--style", str(tmp / "style" / "s.png"), "--out",
         str(tmp / out_name), "--mode", mode, "--batch", "4", "--device",
         "cuda", *extra])
    return text, len(list((tmp / out_name).glob("*.png")))


def _wide_serve(dev, rng):
    """Phase 20: the adain / wct int8 main path through the user's entry
    points. Returns the in-process main path's B5 launches."""
    import numpy as np
    import torch
    from PIL import Image
    from rpst_torch.config import load_config
    from rpst_torch.data import load_image
    from rpst_torch.models import build_model
    from rpst_torch.models.fast_path_q8_std import std_q8_plan
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.serving import (DynamicBatcher, calibrate_scales,
                                    make_run_impl, resolve_mode)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for sub in ("content", "style"):
            (tmp / sub).mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                            "RGB").save(tmp / "content" / f"c{i}.png")
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                        "RGB").save(tmp / "style" / "s.png")
        cfg_path = tmp / "adain.yaml"
        cfg_path.write_text(json.dumps(dict(WIDE, network="adain",
                                            img_size=IMG)))
        cfg = load_config(str(cfg_path))
        bundle = build_model(cfg, dev)
        init_torch_default(bundle.model, cfg.seed)
        plan = std_q8_plan(*bundle.std_weights(torch.float32))
        if plan != {"scales": 5, "B5": 4}:
            raise AssertionError(f"adain h32 plan {plan}")
        mode = resolve_mode(bundle, "q8", batch=4)
        if mode != "q8" or resolve_mode(bundle, "auto", batch=4) == "folded":
            raise AssertionError(f"adain resolve_mode gave {mode}")
        imgs = [load_image(tmp / "content" / f"c{i}.png", IMG)
                for i in range(8)]
        style_img = load_image(tmp / "style" / "s.png", IMG)
        calib = torch.from_numpy(np.stack(imgs[:4])).to(dev)
        scales = calibrate_scales(bundle, calib, torch.from_numpy(
            style_img)[None].to(dev).expand_as(calib).contiguous())
        if len(scales["act_scales"]) != plan["scales"]:
            raise AssertionError(f"{len(scales['act_scales'])} scales")
        batcher = DynamicBatcher(make_run_impl(bundle, mode, scales),
                                 batch_size=4, max_wait_ms=50.0, device=dev)
        _reset_counts()  # this main path's count starts here
        try:
            outs = [f.result(timeout=600) for f in
                    [batcher.submit(im, style_img) for im in imgs]]
        finally:
            batcher.close()
        launches = _counters()["B5"].launches
        batches = batcher.stats()["batches"]
        if launches != batches * plan["B5"] or batches < 2:
            raise AssertionError(f"adain q8 main path: {launches} B5 "
                                 f"launches in {batches} batches")
        std = bundle.stylize(torch.from_numpy(np.stack(imgs[:4])).to(dev),
                             torch.from_numpy(style_img)[None].to(dev)
                             .expand(4, -1, -1, -1).contiguous()).cpu().numpy()
        psnr = _psnr(np.stack(outs[:4]), std)
        for o in outs:
            if o.shape != (IMG, IMG, 3) or not np.isfinite(o).all():
                raise AssertionError(f"adain q8 main path output {o.shape}")
        if not psnr > Q8_VS_FOLDED_PSNR:
            raise AssertionError(f"adain q8 vs standard f32: PSNR {psnr} dB")
        log("20 wide serve", f"adain h32 512px: 8 requests via "
            f"DynamicBatcher(b4): {batcher.stats()}, {launches} B5 launches "
            f"({batches} batches x {plan['B5']}); q8 vs standard f32 PSNR "
            f"{psnr:.2f} dB (bound > {Q8_VS_FOLDED_PSNR})")
        del bundle, batcher, calib
        torch.cuda.empty_cache()

        wct_path = tmp / "wct.yaml"
        wct_path.write_text(json.dumps(dict(WIDE, network="wct",
                                            img_size=IMG)))
        for label, path, extra, per_call, n_scales in (
                ("adain h32", cfg_path, (), 4, 5),
                ("adain h16 (configs/train_deeper_rp_adain.yaml)",
                 ADAIN_YAML, ("--set", f"img_size={IMG}"), 2, 3),
                ("wct h32", wct_path, (), 4, 5)):
            t0 = time.perf_counter()
            text, n_png = _serve_child(path, tmp, label.split()[0] + str(
                per_call), "q8", extra)
            child = _logged_count(text, "B5")
            if (n_png != 8 or child != 2 * per_call
                    or f"Calibrated {n_scales} layer scales" not in text):
                raise AssertionError(f"serve_torch {label}: {n_png} PNGs, "
                                     f"{child} B5 launches:\n{text[-3000:]}")
            rate = [ln for ln in text.splitlines() if "Stylized" in ln]
            log("20 wide serve", f"serve_torch.py {label} --mode q8: 8 PNGs, "
                f"'Calibrated {n_scales} layer scales', {child} B5 launches "
                f"(2 batches x {per_call}), {time.perf_counter() - t0:.1f}s "
                f"wall; {rate[-1].split(' - ')[-1] if rate else ''}")
    return launches


def _q8_targets_train(dev):
    """Phase 21: train_torch.py with train_q8_targets=true on a 512px
    synthetic corpus, b4 f32 folded, 3 steps through the entry point in this
    process, counts reset before and read after. Returns the B1/B2/B3/B5
    launches."""
    import importlib.util
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "8", "--size", str(IMG)],
                       check=True, capture_output=True, timeout=300)
        out = tmp / "run"
        cfg_path = tmp / "train.yaml"
        cfg_path.write_text(json.dumps(dict(
            FLAGSHIP, img_size=IMG, exec_strategy="folded", batch_size=4,
            max_iter=4, snapshot_save_iter=100, log_iter=1, num_workers=4,
            train_q8_targets=True,
            content_dir=str(tmp / "corpus" / "content"),
            style_dir=str(tmp / "corpus" / "style"), output=str(out))))
        spec = importlib.util.spec_from_file_location(
            "train_torch", REPO / "train_torch.py")
        driver = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(driver)
        _reset_counts()  # the main path's count starts here
        t0 = time.perf_counter()
        driver.main(["--config", str(cfg_path), "--device", "cuda"])
        launches = _counts(("B1", "B2", "B3", "B5"))
        want = tuple(3 * n for n in PER_STEP_Q8T + (B5_PER_TARGET_PASS,))
        if launches != want:
            raise AssertionError(f"q8-targets train launches {launches}, "
                                 f"expected 3 steps x "
                                 f"{PER_STEP_Q8T + (B5_PER_TARGET_PASS,)}")
        lines = [json.loads(ln) for ln in
                 (out / "logs" / "metrics.jsonl").read_text().splitlines()]
        losses = [ln["total_loss"] for ln in lines]
        if [ln["step"] for ln in lines] != [1, 2, 3] \
                or not np.isfinite(losses).all() \
                or any(ln["skipped"] for ln in lines):
            raise AssertionError(f"metrics.jsonl: {lines}")
    log("21 q8-targets train", f"train_torch.py b4 512px f32 folded, "
        f"train_q8_targets=true, 3 steps in {time.perf_counter() - t0:.1f}s "
        f"wall: total_loss {[round(v, 6) for v in losses]}; B1/B2/B3/B5 "
        f"launches {launches} (3 steps x "
        f"{PER_STEP_Q8T + (B5_PER_TARGET_PASS,)})")
    return launches


def _wide_timing(dev, rng, name_power):
    """Phase 22: 512px stylize of adain (b1, b4) and wct (b1), standard
    f32 / bf16 vs q8 (bf16 around the int8 layers, as served); the
    flagship's train step b1 / b4 with and without int8 targets. CUDA
    events, medians."""
    import numpy as np
    import torch
    from rpst_torch import policy
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.models.fast_path_q8_std import calibrate_vgg_targets_q8
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.train.step import create_train_state, train_step

    def pair(batch):
        return tuple(torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                                 np.float32)).to(dev)
                     for _ in range(2))

    for network, batches in (("adain", (1, 4)), ("wct", (1,))):
        bundle = _rpseq_bundle(network, dev, IMG)
        with torch.inference_mode():
            for batch in batches:
                c, s = pair(batch)
                scales = bundle.calibrate_q8(c, s)
                paths = {
                    "standard f32": lambda: _standard(bundle, c, s,
                                                      torch.float32),
                    "standard bf16": lambda: _standard(bundle, c, s,
                                                       torch.bfloat16),
                    "q8 B5": lambda: bundle.stylize_q8(c, s, scales)}
                # one order: the script's time limit
                for path in ("standard f32", "standard bf16", "q8 B5"):
                    fn = paths[path]
                    ms = cuda_ms(fn, iters=3, warmup=1)
                    log("22 wide timing", f"{network} 512px b{batch} "
                        f"{path:14s}: {ms:9.3f} ms {batch * 1e3 / ms:8.2f} "
                        f"img/s ({name_power})")
        del bundle
        torch.cuda.empty_cache()

    cfg = load_config(dict(FLAGSHIP, img_size=IMG, exec_strategy="folded",
                           train_q8_targets=True))
    vgg, _ = build_vgg(cfg, dev)
    min_batch = policy.TRAIN_Q8_TARGETS_MIN_BATCH
    try:
        policy.TRAIN_Q8_TARGETS_MIN_BATCH = 1  # time both sides at b1 too
        for batch in (1, 4):
            c, s = pair(batch)
            scales = calibrate_vgg_targets_q8(vgg, c, s)
            for dt in ("float32", "bfloat16"):
                # one order: the script's time limit
                for label, sc in (("float targets", None),
                                  ("int8 targets B5", scales)):
                    bundle = build_model(cfg.replace(compute_dtype=dt), dev)
                    init_torch_default(bundle.model, cfg.seed)
                    bundle.q8_target_scales = sc
                    state = create_train_state(bundle)
                    ms = cuda_ms(lambda: train_step(state, vgg, c, s),
                                 iters=3, warmup=1)
                    log("22 wide timing", f"train step 512px b{batch} "
                        f"{dt:8s} {label:16s}: {ms:9.3f} ms/step "
                        f"{batch * 1e3 / ms:8.2f} img/s ({name_power})")
                    del state, bundle
                    torch.cuda.empty_cache()
    finally:
        policy.TRAIN_Q8_TARGETS_MIN_BATCH = min_batch


# ---------------------------------------------------------------- B6 / sanet

SANET_FIXTURE = REPO / "tests" / "fixtures" / "torch_port_sanet.npz"
SANET_YAML = REPO / "configs" / "train_static_sanet.yaml"
# (label, (N, Nq, Nk, C)): the two attention modules of a 512px stylize
B6_SHAPES = (("relu4_1 b1", (1, 4096, 4096, 512)),
             ("relu5_1 b1", (1, 1024, 1024, 512)),
             ("relu4_1 b4", (4, 4096, 4096, 512)),
             ("relu5_1 b4", (4, 1024, 1024, 512)))
B6_JSON_SHAPE = "relu4_1 b1"
# (N, Nq, Nk, C) around the bfloat16 forward's tiles (32 query rows x 64
# keys): one below, at and one above each, at the widths below 512, N = 3
B6_FWD_EDGES = tuple((3, nq, nk, c) for c in (128, 256, 384)
                     for nq, nk in ((31, 63), (32, 64), (33, 65)))
LSE_TOL = 1e-4
# per 512px SANet call: two attention modules per stylize; the q8 plan's 16
# B5 (VGG conv_4 .. conv_13 on the 2N batch, mirror conv0 .. conv5); a train
# step runs three stylize passes (stylized, content-content, style-style),
# each module's forward with LSE once and both backward kernels once (f, g
# and h are trained, so dQ, dK and dV are all needed)
B6_PER_STYLIZE, SANET_Q8_B5, B6_PER_STEP = 2, 16, (6, 6, 6)
# the bfloat16 instances of B6 that no path launches: the one-device static
# SANet's transform runs float32 as rpst's, and only the row-sharded
# bfloat16 stylize (phase 60) launches the bfloat16 forward (phase 23 still
# holds them all against plain)
OFF_PATH = ("flash_fwd_lse_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16",
            "flash_fwd_lse_bf16_row_share", "flash_bwd_dq_bf16_row_share",
            "flash_bwd_dkv_bf16_row_share")
# gradients through the softmax (f and g, and f's bias): logits with a
# standard deviation near 8 amplify the float32 rounding of the scores, so
# the two frameworks' sums agree to ~1e-3 of the tensor's max there
SANET_SOFTMAX_GRAD_ATOL_REL = 2e-3
# the other leaves: the flagship's rtol (5e-3) with atol 5e-4 x max instead
# of its 1e-4: the loss runs five 14-conv VGG encodes and three decodes on
# cuDNN's float32 kernels, which sum in another order than the fixture's CPU
# convs (the first run on the card read 1.9e-4 at sanet5_1.h.bias)
SANET_GRAD_ATOL_REL = 5e-4
# q8 with rpst's scales, float32 around the int8 layers: 35 dB on the card,
# where the CPU test holds 40 (it reads 44.9). The narrow float layers run on
# cuDNN, whose float32 sums differ in the last bits from the fixture's CPU
# convs; that flips a few first quantizations, and 16 chained int8 layers
# with two peaked softmax modules between them spread the flips (the card
# read 40.2 dB). bfloat16: the 30 dB of the other q8 fixtures.
SANET_Q8_F32_PSNR = 35.0
# bfloat16 around the int8 layers with the attention transform in float32,
# as rpst's: the card reads 43.1 dB, the CPU test 38.8 (30 before the
# transform's type was repaired)
SANET_Q8_BF16_PSNR = 40.0


def _attention_inputs(dev, dtype, n, nq, nk, c, scale=1.0, seed=0):
    """q, k, v, d_o with logits of order scale^2 (rows of norm ~C^(1/4))."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + n + nq + nk)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * scale / c ** 0.25).to(dev).to(dtype)
    return t(n, nq, c), t(n, nk, c), t(n, nk, c), t(n, nq, c)


def _sdpa(q, k, v):
    """The one library call that computes B6's function: unscaled, unmasked
    attention with one head of width C. In this script only."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1), scale=1.0).squeeze(1)


def _sdpa_backends(q, k, v):
    """The SDPA backends that accept this call, in the library's names."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ok = []
    for name in ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:  # a PyTorch that predates this backend
            continue
        try:
            with sdpa_kernel(backend):
                _sdpa(q, k, v)
            torch.cuda.synchronize()
            ok.append(backend.name)
        except RuntimeError:
            pass
    return ok


def _b6_compare(label, dev, dtype, shape, scale, tol):
    """B6a-d against their plain versions on one input (float32 at scale !=
    1, the forward's O and the gradients, against float64 oracles instead,
    by ``fa.f32_oracle_limit``); returns the max abs error against plain per
    kernel held to it."""
    import torch
    from rpst_torch.ops import flash_attention as fa
    q, k, v, d_o = _attention_inputs(dev, dtype, *shape, scale=scale)
    o = fa.flash_fwd(q, k, v)
    o2, lse = fa.flash_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v)
    f32 = dtype == torch.float32
    if f32 and scale != 1.0:
        ref64 = fa.attention_f64(q, k, v)
        limit = fa.f32_oracle_limit(ref_o, ref64)
        ora = max(check_oracle(f"{key} {label}", got, ref64, limit)
                  for key, got in (("B6a", o), ("B6b", o2)))
        err = {}
        fwd = (f"fwd O from the float64 oracle {ora:.3g} (limit {limit:.3g}: "
               f"{fa.F32_ORACLE_X:g}x max(plain's "
               f"{(ref_o.double() - ref64).abs().max().item():.3g}, 2^-20 "
               f"max |O|))")
    else:
        err = {"B6a": check_close(f"B6a {label}", o, ref_o, tol)[0],
               "B6b": check_close(f"B6b {label}", o2, ref_o, tol)[0]}
        fwd = f"fwd {err['B6a']:.3g}, fwd+lse {err['B6b']:.3g}"
    scaled = ""
    if scale == 1.0:  # both tensor-core forwards, at O's own size
        rel_max, rel_mean = ((fa.F32_O_REL, fa.F32_O_MEAN_REL) if f32
                             else (BF16_O_REL, BF16_O_MEAN_REL))
        rel = [check_scaled(f"{key} {label}", got, ref_o, rel_max, rel_mean)
               for key, got in (("B6a", o), ("B6b", o2))]
        scaled = (f"; fwd O err / max |ref|: max {max(r[0] for r in rel):.3g}"
                  f" (limit {rel_max}), mean {max(r[1] for r in rel):.3g} "
                  f"(limit {rel_mean})")
    # the LSE's own tolerance scales with the logits' size
    lse_err = (lse - ref_lse).abs().max().item()
    if not torch.allclose(lse, ref_lse, rtol=LSE_TOL, atol=LSE_TOL):
        raise AssertionError(f"B6b {label} lse: max abs err {lse_err}")
    delta = (d_o.float() * ref_o.float()).sum(-1)
    bwd, text, _ = _b6_backward(label, q, k, v, d_o, ref_lse, delta, scale,
                                tol)
    log("23 B6 kernels", f"{label} {shape} {str(dtype)[6:]} x{scale:g}: max "
        f"abs err {fwd} (lse {lse_err:.3g}), {text}{scaled}")
    return {**err, **bwd}


def _b6_backward(label, q, k, v, d_o, lse, delta, scale, tol):
    """B6c and B6d under ``fa.check_backward``: against their plain
    versions, at their own size (float32 at x 1 from the float64 oracle of
    their own function, bfloat16 from the plain versions), float32 at x 30
    from that oracle by ``fa.f32_oracle_limit`` in place of the plain
    version, each run twice for bit-equal results. Returns the max abs error
    against plain per kernel held to it, the log text, and the worst (max,
    mean) share of max |ref| of the own-size checks (None where none was
    taken)."""
    from rpst_torch.ops import flash_attention as fa
    try:
        readings = fa.check_backward(q, k, v, d_o, lse, delta, tol, scale)
    except AssertionError as e:
        raise AssertionError(f"{label}: {e}") from None
    kernel = {"dq": "B6c", "dk": "B6d", "dv": "B6d"}
    err, own = {}, None
    for name, r in readings.items():
        if r["plain"] is not None:
            err[kernel[name]] = max(err.get(kernel[name], 0.0), r["plain"])
        if "own" in r:
            own = tuple(max(a, b) for a, b in zip(own or (0.0, 0.0),
                                                  r["own"]))
    return err, (f"{fa.describe_backward(readings)} (tol {tol}); dQ, dK, dV "
                 f"bit-equal across two runs"), own


def _b6_kernels(dev, name_power):
    """Phase 23: B6a-d against their plain versions, then timed beside
    plain, SDPA and their bounds at every shape of a 512px stylize. Returns
    the kernels JSON numbers per kernel at B6_JSON_SHAPE: B6a-d in f32, and
    the bfloat16 forward (a kernel of its own) as B6a_bf16 / B6b_bf16."""
    import torch
    from rpst_torch.ops import flash_attention as fa
    worst = {k: 0.0 for k in ("B6a", "B6b", "B6c", "B6d")}
    worst_bf16 = {k: 0.0 for k in ("B6a", "B6b", "B6c", "B6d")}
    worst_rel = [0.0, 0.0]
    for shape in B6_FWD_EDGES:
        q, k, v, _ = _attention_inputs(dev, torch.bfloat16, *shape)
        o = fa.flash_fwd(q, k, v)
        o2, lse = fa.flash_fwd_lse(q, k, v)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v)
        worst_bf16["B6a"] = max(worst_bf16["B6a"], check_close(
            f"B6a edge {shape}", o, ref_o, BF16_TOL)[0])
        worst_bf16["B6b"] = max(worst_bf16["B6b"], check_close(
            f"B6b edge {shape}", o2, ref_o, BF16_TOL)[0])
        for got in (o, o2):
            rel = check_scaled(f"B6 edge {shape}", got, ref_o, BF16_O_REL,
                               BF16_O_MEAN_REL)
            worst_rel = [max(a, b) for a, b in zip(worst_rel, rel)]
        if not torch.allclose(lse, ref_lse, rtol=LSE_TOL, atol=LSE_TOL):
            raise AssertionError(f"B6b edge {shape} lse: max abs err "
                                 f"{(lse - ref_lse).abs().max().item()}")
    log("23 B6 kernels", f"bf16 forward at {len(B6_FWD_EDGES)} tile-edge "
        f"shapes (N = 3; C 128, 256, 384; Nq 31-33, Nk 63-65): max abs err "
        f"{max(worst_bf16.values()):.3g} (tol {BF16_TOL}), err / max |ref| "
        f"max {worst_rel[0]:.3g} (limit {BF16_O_REL}), mean "
        f"{worst_rel[1]:.3g} (limit {BF16_O_MEAN_REL}), lse within "
        f"{LSE_TOL}")
    worst_rel = [0.0, 0.0]
    edges_f32 = [(3, nq, nk, c) for c in (128, 256, 384, 512)
                 for nq, nk in fa.F32_FWD_EDGES]
    for shape in edges_f32:
        q, k, v, _ = _attention_inputs(dev, torch.float32, *shape)
        o = fa.flash_fwd(q, k, v)
        o2, lse = fa.flash_fwd_lse(q, k, v)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v)
        if not torch.equal(o, o2):
            raise AssertionError(f"B6 edge {shape} f32: B6a and B6b differ")
        worst["B6a"] = max(worst["B6a"], check_close(
            f"B6a edge {shape}", o, ref_o, F32_TOL)[0])
        worst["B6b"] = max(worst["B6b"], check_close(
            f"B6b edge {shape}", o2, ref_o, F32_TOL)[0])
        rel = check_scaled(f"B6 edge {shape} f32", o, ref_o, fa.F32_O_REL,
                           fa.F32_O_MEAN_REL)
        worst_rel = [max(a, b) for a, b in zip(worst_rel, rel)]
        if not torch.allclose(lse, ref_lse, rtol=LSE_TOL, atol=LSE_TOL):
            raise AssertionError(f"B6b edge {shape} f32 lse: max abs err "
                                 f"{(lse - ref_lse).abs().max().item()}")
    log("23 B6 kernels", f"f32 forward at {len(edges_f32)} tile-edge "
        f"shapes (N = 3; C 128-512; Nq 31-33, Nk 31-33 and 65): max abs err "
        f"{max(worst['B6a'], worst['B6b']):.3g} (tol {F32_TOL}), err / max "
        f"|ref| max {worst_rel[0]:.3g} (limit {fa.F32_O_REL}), mean "
        f"{worst_rel[1]:.3g} (limit {fa.F32_O_MEAN_REL}); B6a and B6b "
        f"bit-equal; lse within {LSE_TOL}")
    # around the backward kernels' tiles (16 rows a block x 32 swept rows,
    # both types), at every width, N = 3
    edges_bwd = [(3, nq, nk, c) for c in (128, 256, 384, 512)
                 for nq, nk in fa.BWD_EDGES]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        edge, own = {"B6c": 0.0, "B6d": 0.0}, (0.0, 0.0)
        for shape in edges_bwd:
            q, k, v, d_o = _attention_inputs(dev, dtype, *shape)
            ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v)
            delta = (d_o.float() * ref_o.float()).sum(-1)
            e, _, rel = _b6_backward(f"edge {shape}", q, k, v, d_o, ref_lse,
                                     delta, 1.0, tol)
            edge = {key: max(edge[key], e[key]) for key in edge}
            own = tuple(max(a, b) for a, b in zip(own, rel or own))
        for key, val in edge.items():
            if dtype == torch.float32:
                worst[key] = max(worst[key], val)
            else:
                worst_bf16[key] = max(worst_bf16[key], val)
        log("23 B6 kernels", f"{str(dtype)[6:]} backward at "
            f"{len(edges_bwd)} tile-edge shapes (N = 3; C 128-512; (Nq, "
            f"Nk) {fa.BWD_EDGES}): max abs err dq {edge['B6c']:.3g}, dk/dv "
            f"{edge['B6d']:.3g} (tol {tol}), from the "
            + (f"float64 oracle max {own[0]:.3g} / mean {own[1]:.3g} of max "
               f"|ref| (limits {fa.F32_GRAD_REL} / {fa.F32_GRAD_MEAN_REL})"
               if dtype == torch.float32 else
               f"plain version max {own[0]:.3g} / mean {own[1]:.3g} of max "
               f"|ref| (limits {fa.BF16_GRAD_REL} / "
               f"{fa.BF16_GRAD_MEAN_REL})")
            + "; dQ, dK, dV bit-equal across two runs")
    for label, shape, dtype, scale in (
            ("ragged", (2, 100, 70, 512), torch.float32, 1.0),
            ("ragged", (2, 100, 70, 512), torch.bfloat16, 1.0),
            ("tiny", (1, 1, 1, 128), torch.float32, 1.0),
            ("ragged x30", (2, 100, 70, 512), torch.float32, 30.0),
            ("relu5_1 x30", (1, 1024, 1024, 512), torch.float32, 30.0)):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for k, e in _b6_compare(label, dev, dtype, shape, scale, tol).items():
            if dtype == torch.float32:
                worst[k] = max(worst[k], e)
            elif k in worst_bf16:
                worst_bf16[k] = max(worst_bf16[k], e)
    out = {}
    for label, shape in B6_SHAPES:
        n, nq, nk, c = shape
        for dtype, tol, kind, size in ((torch.float32, F32_TOL, "f32", 4),
                                       (torch.bfloat16, BF16_TOL, "bf16", 2)):
            for k, e in _b6_compare(label, dev, dtype, shape, 1.0,
                                    tol).items():
                if dtype == torch.float32:
                    worst[k] = max(worst[k], e)
                elif k in worst_bf16:
                    worst_bf16[k] = max(worst_bf16[k], e)
            q, k_, v, d_o = _attention_inputs(dev, dtype, *shape)
            with torch.no_grad():
                o, lse = fa.flash_fwd_lse(q, k_, v)
                delta = (d_o.float() * o.float()).sum(-1)
                ms = {"B6a": cuda_ms(lambda: fa.flash_fwd(q, k_, v), iters=10),
                      "B6b": cuda_ms(lambda: fa.flash_fwd_lse(q, k_, v),
                                     iters=10),
                      "B6c": cuda_ms(lambda: fa.flash_bwd_dq(
                          q, k_, v, d_o, lse, delta), iters=10),
                      "B6d": cuda_ms(lambda: fa.flash_bwd_dkv(
                          q, k_, v, d_o, lse, delta), iters=10)}
                fwd_plain = cuda_ms(lambda: fa.flash_fwd_lse_plain(q, k_, v),
                                    iters=3, warmup=1)
                plain = {"B6a": fwd_plain, "B6b": fwd_plain,
                         "B6c": cuda_ms(lambda: fa.flash_bwd_dq_plain(
                             q, k_, v, d_o, lse, delta), iters=3, warmup=1),
                         "B6d": cuda_ms(lambda: fa.flash_bwd_dkv_plain(
                             q, k_, v, d_o, lse, delta), iters=3, warmup=1)}
                backends = _sdpa_backends(q, k_, v)
                lib_fwd = cuda_ms(lambda: _sdpa(q, k_, v), iters=10)
            leaves = [t.clone().requires_grad_(True) for t in (q, k_, v)]
            graph = _sdpa(*leaves)
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(
                graph, leaves, d_o, retain_graph=True), iters=5, warmup=2)
            del graph, leaves
            lib = {"B6a": lib_fwd, "B6b": lib_fwd, "B6c": lib_bwd,
                   "B6d": lib_bwd}
            qb, kb, rows = n * nq * c * size, n * nk * c * size, n * nq * 4
            work = n * nq * nk * c
            bounds = {  # operations; bytes in + bytes out
                "B6a": bound_ms(4 * work, qb + 2 * kb + qb, kind),
                "B6b": bound_ms(4 * work, qb + 2 * kb + qb + rows, kind),
                "B6c": bound_ms(6 * work, 2 * qb + 2 * kb + 2 * rows + qb,
                                kind),
                "B6d": bound_ms(8 * work, 2 * qb + 2 * kb + 2 * rows + 2 * kb,
                                kind)}
            for key in ("B6a", "B6b", "B6c", "B6d"):
                b_ms, b_by = bounds[key]
                log("23 B6 kernels", f"{label} {shape} {kind} {key}: "
                    f"{ms[key]:.4f} ms vs plain {plain[key]:.4f}, SDPA "
                    f"{'forward' if key in ('B6a', 'B6b') else 'backward'} "
                    f"{lib[key]:.4f} (backends that take the call: "
                    f"{backends}); bound {b_ms:.4f} ms by {b_by} "
                    f"({100 * b_ms / ms[key]:.1f}% of it reached"
                    + (f"; the 3xTF32 ceiling {3 * b_ms:.4f} ms, "
                       f"{100 * 3 * b_ms / ms[key]:.1f}% of it"
                       if kind == "f32" and b_by == "operations" else "")
                    + f"; {name_power})")
                if label == B6_JSON_SHAPE and (dtype == torch.float32
                                               or key in worst_bf16):
                    name = key if dtype == torch.float32 else key + "_bf16"
                    out[name] = {"ms": ms[key], "plain_ms": plain[key],
                                 "bound_ms": b_ms, "bound_by": b_by,
                                 "library_ms": lib[key]}
            del q, k_, v, d_o, o, lse, delta
            torch.cuda.empty_cache()
    for key in out:
        out[key]["max_abs_err"] = (worst_bf16[key[:3]]
                                   if key.endswith("_bf16") else worst[key])
    return out


def _sanet_bundle(dev, size, seeded=True, **over):
    """A static-SANet bundle with its 5-stage VGG set: the fixture's seeded
    weights, or what the drivers seed without --weights."""
    from rpst_torch.bridge import from_flax_params, sanet_weights_from_seed
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.nn.blocks import init_torch_default
    cfg = load_config(str(SANET_YAML), dict(img_size=size, test_dir="", vgg="",
                                            **over))
    bundle = build_model(cfg, dev)
    if seeded:
        bundle.load_state_dict(from_flax_params(sanet_weights_from_seed(0)))
    else:
        init_torch_default(bundle.model, cfg.seed)
    bundle.vgg, _ = build_vgg(cfg, dev)
    return bundle


def _sanet_fixture(dev):
    """Phase 24: the static SANet on the card vs rpst's JAX outputs."""
    import numpy as np
    import torch
    from rpst_torch.bridge import (from_flax_params, sanet_weights_from_seed,
                                   vgg_from_flax, vgg_weights_from_seed)
    from rpst_torch.models.fast_path_q8_std import sanet_q8_plan
    from rpst_torch.nn.vgg import VGG19Encoder
    with np.load(SANET_FIXTURE) as npz:
        fx = {k: npz[k] for k in npz.files}
    bundle = _sanet_bundle(dev, fx["content"].shape[1])
    bundle.load_state_dict(from_flax_params(sanet_weights_from_seed(
        int(fx["weights_seed"]))))
    vgg = VGG19Encoder(5)
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]), 5)))
    bundle.vgg = vgg = vgg.to(dev)
    c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
    plan = sanet_q8_plan(vgg, bundle.q8_weights())
    if plan != {"scales": len(fx["act_scales"]), "B5": SANET_Q8_B5,
                "B6": B6_PER_STYLIZE}:
        raise AssertionError(f"sanet q8 plan {plan}")
    _reset_counts()
    out = bundle.stylize(c, s)
    torch.cuda.synchronize()
    if _counts(("B6a", "B5")) != (B6_PER_STYLIZE, 0):
        raise AssertionError(f"sanet stylize launches {_counts(('B6a', 'B5'))}")
    err, mae = check_close("sanet fixture standard f32", out,
                           torch.from_numpy(fx["out_f32"]).to(dev), F32_TOL)
    msg = [f"standard f32 max abs err {err:.3g}, MAE {mae:.3g} (tol "
           f"{F32_TOL}), {B6_PER_STYLIZE} B6"]
    scales = {"act_scales": fx["act_scales"]}
    for dt, key, min_psnr in ((torch.float32, "out_q8_f32", SANET_Q8_F32_PSNR),
                              (torch.bfloat16, "out_q8_bf16",
                               SANET_Q8_BF16_PSNR)):
        _reset_counts()
        got = bundle.stylize_q8(c, s, scales, dtype=dt).cpu().numpy()
        # the attention transform is float32 in both types (rpst's)
        n = _counts(("B5", "B6a")) + (_bf16_fwd_counts()[0],)
        psnr = _psnr(got, fx[key])
        if not (np.isfinite(got).all() and psnr >= min_psnr
                and n == (SANET_Q8_B5, B6_PER_STYLIZE, 0)):
            raise AssertionError(f"sanet fixture {key}: PSNR {psnr} dB, B5 / "
                                 f"B6 launches {n}")
        msg.append(f"{key} PSNR {psnr:.2f} dB (>= {min_psnr})")
    _reset_counts()
    own = bundle.calibrate_q8(c, s)["act_scales"]
    if _counts(("B5", "B6a")) != (0, B6_PER_STYLIZE) \
            or not np.allclose(own, fx["act_scales"], rtol=2e-2):
        raise AssertionError(f"sanet calibration {own} vs rpst "
                             f"{fx['act_scales']}, launches "
                             f"{_counts(('B5', 'B6a'))}")
    # the loss and its gradients (train mode changes nothing: no BatchNorm)
    _reset_counts()
    total, parts = bundle.loss(vgg, c, s)
    total.backward()
    torch.cuda.synchronize()
    if _counts(("B6b", "B6c", "B6d")) != B6_PER_STEP:
        raise AssertionError(f"sanet loss launches "
                             f"{_counts(('B6b', 'B6c', 'B6d'))}")
    for k in ("content_loss", "style_loss", "l_identity1_loss",
              "l_identity2_loss", "total_loss"):
        got, want = float(parts[k].detach()), float(fx[k])
        if not abs(got - want) <= LOSS_RTOL * abs(want):
            raise AssertionError(f"sanet fixture {k}: {got} vs rpst {want}")
    worst = _check_sanet_grads(bundle.model, fx)
    log("24 sanet fixture", f"64px b2 vs rpst JAX: {'; '.join(msg)}; "
        f"{plan['B5']} B5 + {plan['B6']} B6 per q8 stylize, {plan['scales']} "
        f"scales within 2e-2 of rpst's; total_loss "
        f"{float(parts['total_loss'].detach()):.7g} vs "
        f"{float(fx['total_loss']):.7g}, worst gradient err / max {worst:.3g}; "
        f"B6 fwd/dq/dkv {B6_PER_STEP} per loss")


def _check_sanet_grads(model, fx):
    """The model's gradients against the fixture's: every bias in full, the
    [..., :8, :8] corner of every kernel (dynamic_sanet's psi Linears in
    rpst's (in, out) layout), every leaf's norm. The g convs' biases shift
    all of a query's logits alike, so their gradient is zero up to rounding:
    held below 1e-3 of the f bias's. The f, g and psi leaves lie behind the
    softmax. Returns the worst max abs err / max |ref|; raises with every
    leaf that is out of tolerance."""
    import numpy as np
    params = dict(model.named_parameters())
    worst, bad = 0.0, []
    for key, ref in fx.items():
        kind, _, path = key.partition("/")
        if kind not in ("grads", "gradpatch", "gradnorm"):
            continue
        name = _port_grad_name(path)
        grad = params[name].grad.detach().float()
        if grad.ndim == 2:
            grad = grad.t()
        if name.endswith(".g.bias"):
            f_max = params[name.replace(".g.", ".f.")].grad.abs().max().item()
            if not grad.abs().max().item() <= 1e-3 * f_max:
                bad.append(f"{name}: gradient {grad.abs().max().item()} not "
                           f"~0 (f bias max {f_max})")
            continue
        if kind == "gradnorm":
            if not abs(grad.norm().item() - float(ref)) <= 1e-3 * float(ref):
                bad.append(f"{name}: norm {grad.norm().item()} vs {ref}")
            continue
        got = (grad if kind == "grads" else grad[:8, :8] if grad.ndim == 2
               else grad.permute(2, 3, 1, 0)[..., :8, :8]).cpu().numpy()
        scale = float(np.abs(ref).max())
        softmax = any(t in name for t in (".f.", ".g.", ".attention_layer."))
        rel = SANET_SOFTMAX_GRAD_ATOL_REL if softmax else SANET_GRAD_ATOL_REL
        err = float(np.abs(got - ref).max()) / max(scale, 1e-30)
        if not (np.isfinite(got).all() and np.allclose(
                got, ref, rtol=GRAD_RTOL, atol=rel * scale)):
            bad.append(f"{name} ({kind}): max abs err / max |ref| {err:.3g} "
                       f"(atol {rel} x max)")
        worst = max(worst, err)
    if bad:
        raise AssertionError("sanet gradients vs rpst:\n" + "\n".join(bad))
    return worst


def _plain_attention(f, g, h):
    from rpst_torch.ops.flash_attention import flash_fwd_plain
    return flash_fwd_plain(f, g, h)


def _sanet_parity(dev, rng):
    """Phase 25: 512px b2, the model on B6 vs the same model on the plain
    attention, f32 and bf16; launches per stylize."""
    import numpy as np
    import torch
    c, s = (torch.from_numpy(rng.random((2, IMG, IMG, 3), np.float32)).to(dev)
            for _ in range(2))
    msg = []
    for dt, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        bundle = _sanet_bundle(dev, IMG, compute_dtype=dt)
        _reset_counts()
        out = bundle.stylize(c, s)
        torch.cuda.synchronize()
        n = _counts(("B6a",))[0]
        bundle.model.attention = _plain_attention
        ref = bundle.stylize(c, s)
        torch.cuda.synchronize()
        if n != B6_PER_STYLIZE or _counts(("B6a",))[0] != n:
            raise AssertionError(f"sanet stylize {dt}: {n} B6 launches")
        # bf16: relative to the output's spread (the decoder amplifies the
        # attention's one-ulp differences)
        span = float(ref.max() - ref.min())
        err = (out - ref).abs().max().item()
        if dt == "float32":
            check_close(f"512px sanet B6 vs plain {dt}", out, ref, tol)
        elif not (torch.isfinite(out).all() and err <= tol * span):
            raise AssertionError(f"512px sanet B6 vs plain bf16: max abs err "
                                 f"{err} > {tol} x span {span}")
        msg.append(f"{dt} max abs err {err:.3g} (span {span:.3g}, tol {tol})")
        del bundle
        torch.cuda.empty_cache()
    log("25 sanet parity", f"{IMG}px b2 B6 vs plain attention: "
        f"{'; '.join(msg)}; {B6_PER_STYLIZE} B6 launches per stylize")


def _sanet_serve(dev, rng):
    """Phase 26: the SANet serving main path, standard and q8, through the
    user's entry points. Returns the in-process runs' B6a and B5 launches,
    and how many of the B6a launches were the bfloat16 kernel's."""
    import numpy as np
    import torch
    from PIL import Image
    from rpst_torch.data import load_image
    from rpst_torch.serving import (DynamicBatcher, calibrate_scales,
                                    make_run_impl, resolve_mode)
    total = {"B6a": 0, "B5": 0, "B6a_bf16": 0}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for sub in ("content", "style"):
            (tmp / sub).mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                            "RGB").save(tmp / "content" / f"c{i}.png")
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                        "RGB").save(tmp / "style" / "s.png")
        imgs = [load_image(tmp / "content" / f"c{i}.png", IMG)
                for i in range(8)]
        style_img = load_image(tmp / "style" / "s.png", IMG)
        bundle = _sanet_bundle(dev, IMG, seeded=False)
        outs = {}
        for asked in ("standard", "q8"):
            mode = resolve_mode(bundle, asked, batch=4)
            if mode != asked or resolve_mode(bundle, "auto", 4) != "standard":
                raise AssertionError(f"sanet resolve_mode({asked}) = {mode}")
            scales = None
            if mode == "q8":
                calib = torch.from_numpy(np.stack(imgs[:4])).to(dev)
                scales = calibrate_scales(bundle, calib, torch.from_numpy(
                    style_img)[None].to(dev).expand_as(calib).contiguous())
                if len(scales["act_scales"]) != 16:
                    raise AssertionError(f"{len(scales['act_scales'])} scales")
            batcher = DynamicBatcher(make_run_impl(bundle, mode, scales),
                                     batch_size=4, max_wait_ms=50.0,
                                     device=dev)
            _reset_counts()  # this main path's count starts here
            try:
                outs[mode] = [f.result(timeout=600) for f in
                              [batcher.submit(im, style_img) for im in imgs]]
            finally:
                batcher.close()
            got = dict(zip(("B6a", "B5"), _counts(("B6a", "B5"))))
            batches = batcher.stats()["batches"]
            want = {"B6a": batches * B6_PER_STYLIZE,
                    "B5": batches * SANET_Q8_B5 * (mode == "q8")}
            if got != want or batches < 2:
                raise AssertionError(f"sanet {mode} main path: launches {got} "
                                     f"in {batches} batches, expected {want}")
            for o in outs[mode]:
                if o.shape != (IMG, IMG, 3) or not np.isfinite(o).all():
                    raise AssertionError(f"sanet {mode} output {o.shape}")
            # q8 serves bfloat16 around the int8 layers, but the attention
            # transform runs float32 as rpst's: no launch of the bfloat16
            # (tensor-core) forward on either path
            got["B6a_bf16"] = _bf16_fwd_counts()[0]
            if got["B6a_bf16"] != 0:
                raise AssertionError(f"sanet {mode} main path: {got}")
            for k in total:
                total[k] += got[k]
            log("26 sanet serve", f"{mode}: 8 requests via DynamicBatcher(b4): "
                f"{batcher.stats()}, launches {got} ({batches} batches)")
        psnr = _psnr(np.stack(outs["q8"]), np.stack(outs["standard"]))
        if not psnr > Q8_VS_FOLDED_PSNR:
            raise AssertionError(f"sanet q8 vs standard f32: PSNR {psnr} dB")
        log("26 sanet serve", f"q8 vs standard f32 PSNR {psnr:.2f} dB (bound > "
            f"{Q8_VS_FOLDED_PSNR})")
        del bundle, batcher
        torch.cuda.empty_cache()

        # the children: 8 PNGs in 2 batches; q8 calibrates first (2 more B6,
        # none of the int8 kernels)
        for mode, b5, b6 in (("standard", 0, 2 * B6_PER_STYLIZE),
                             ("q8", 2 * SANET_Q8_B5, 3 * B6_PER_STYLIZE)):
            t0 = time.perf_counter()
            text, n_png = _serve_child(
                SANET_YAML, tmp, f"sanet_{mode}", mode,
                ("--set", f"img_size={IMG}", "vgg=", "test_dir="))
            child = (_logged_count(text, "B5"), _logged_count(text, "B6"))
            if n_png != 8 or child != (b5, b6) or (
                    mode == "q8"
                    and "Calibrated 16 layer scales" not in text):
                raise AssertionError(f"serve_torch sanet {mode}: {n_png} "
                                     f"PNGs, B5 / B6 launches {child}:\n"
                                     f"{text[-3000:]}")
            rate = [ln for ln in text.splitlines() if "Stylized" in ln]
            log("26 sanet serve", f"serve_torch.py "
                f"configs/train_static_sanet.yaml --mode {mode}: 8 PNGs, B5 / "
                f"B6 launches {child}, {time.perf_counter() - t0:.1f}s wall; "
                f"{rate[-1].split(' - ')[-1] if rate else ''}")
    return total


def _sanet_train(dev):
    """Phase 27: train_torch.py on the repository's static-SANet yaml (512px,
    batch 4, f32): 3 steps in this process, then 2 resumed steps through the
    same entry point in this process, counts reset before and read after.
    Then 2 steps in bfloat16 the same way (the attention transform still
    float32, as rpst's). Returns the B6 forward-with-LSE / dQ / dK/dV
    launches of both runs, all of the float32 kernels."""
    import importlib.util
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "8", "--size", str(IMG)],
                       check=True, capture_output=True, timeout=300)
        out = tmp / "run"
        args = ["--config", str(SANET_YAML), "--device", "cuda", "--set",
                "vgg=", "test_dir=", "num_workers=4", "log_iter=1",
                "snapshot_save_iter=2",
                f"content_dir={tmp / 'corpus' / 'content'}",
                f"style_dir={tmp / 'corpus' / 'style'}", f"output={out}"]
        t0 = time.perf_counter()
        proc = _train_cli([*args, "max_iter=4"])
        text = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise AssertionError(f"train_torch.py sanet rc {proc.returncode}:"
                                 f"\n{text[-3000:]}")
        child = [tuple(int(v) for v in ln.rsplit(":", 1)[1].split("/"))
                 for ln in text.splitlines() if "B6 fwd/dq/dkv launches:" in ln]
        if child != [tuple(3 * n for n in B6_PER_STEP)]:
            raise AssertionError(f"train_torch.py sanet launches {child}, "
                                 f"expected 3 steps x {B6_PER_STEP}:\n"
                                 f"{text[-3000:]}")
        rates = [ln.split("img/s ")[1].split(",")[0]
                 for ln in text.splitlines() if "img/s" in ln]
        log("27 sanet train", f"train_torch.py sanet b4 {IMG}px f32, 3 steps "
            f"in {time.perf_counter() - t0:.1f}s wall (img/s per step "
            f"{rates}); B6 fwd/dq/dkv launches of the 3 steps {child[0]}")

        spec = importlib.util.spec_from_file_location(
            "train_torch", REPO / "train_torch.py")
        train_cli = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(train_cli)
        _reset_counts()  # the main path's count starts here
        train_cli.main([*args, "resume=true", "max_iter=3"])
        launches = _counts(("B6b", "B6c", "B6d"))
        if launches != tuple(2 * n for n in B6_PER_STEP) \
                or _counts(("B6a",)) != (0,):
            raise AssertionError(f"resumed sanet run launches {launches} "
                                 f"(B6a {_counts(('B6a',))}), expected 2 "
                                 f"steps x {B6_PER_STEP}")
        lines = [json.loads(ln) for ln in
                 (out / "logs" / "metrics.jsonl").read_text().splitlines()]
        steps = [ln["step"] for ln in lines]
        losses = [ln["total_loss"] for ln in lines]
        if steps != [1, 2, 3, 4, 5] or not np.isfinite(losses).all() \
                or any(ln["skipped"] for ln in lines):
            raise AssertionError(f"sanet metrics.jsonl: {lines}")
        # the same entry point in bfloat16 (compute_dtype), 2 steps: the
        # attention transform leaves autocast (float32, as rpst's), so the
        # float32 kernels run and the bfloat16 forward never does
        _reset_counts()
        train_cli.main([*args[:-1], f"output={tmp / 'run_bf16'}",
                     "compute_dtype=bfloat16", "max_iter=3"])
        bf16 = _counts(("B6b", "B6c", "B6d"))
        bf16_fwd = _bf16_fwd_counts()[1]
        if bf16 != tuple(2 * n for n in B6_PER_STEP) or bf16_fwd != 0:
            raise AssertionError(f"bf16 sanet run launches {bf16}, bf16 "
                                 f"forward {bf16_fwd}, expected 2 steps x "
                                 f"{B6_PER_STEP}")
        bf16_lines = [json.loads(ln) for ln in (
            tmp / "run_bf16" / "logs" / "metrics.jsonl").read_text()
            .splitlines()]
        if len(bf16_lines) != 2 or not np.isfinite(
                [ln["total_loss"] for ln in bf16_lines]).all():
            raise AssertionError(f"bf16 sanet metrics.jsonl: {bf16_lines}")
    log("27 sanet train", f"resumed at step 3 for steps 4-5; total_loss "
        f"{[round(v, 4) for v in losses]}; B6 fwd+lse/dq/dkv launches "
        f"{launches} (2 steps x {B6_PER_STEP}); bfloat16, 2 steps: {bf16}, "
        f"total_loss {[round(ln['total_loss'], 4) for ln in bf16_lines]}")
    return tuple(a + b for a, b in zip(launches, bf16))


def _sanet_timing(dev, rng, name_power):
    """Phase 28: the 512px SANet stylize (standard f32, bf16, q8) at b1 (b4
    cut for the time limit in PR 20), with B6, with the plain attention and
    with the SDPA call in B6's place, and the train step with B6. CUDA
    events, medians."""
    import numpy as np
    import torch
    from rpst_torch.ops.flash_attention import sanet_attention
    from rpst_torch.train.step import create_train_state, train_step

    def pair(batch):
        return tuple(torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                                 np.float32)).to(dev)
                     for _ in range(2))

    attentions = (("B6", sanet_attention), ("plain", _plain_attention),
                  ("SDPA", _sdpa))
    for batch in (1,):  # b4 cut for the time limit (PR 20)
        c, s = pair(batch)
        for dt in ("float32", "bfloat16"):
            bundle = _sanet_bundle(dev, IMG, compute_dtype=dt)
            paths = [(f"standard {dt}", lambda: bundle.stylize(c, s))]
            if dt == "bfloat16":  # q8 serves in bf16 around the int8 layers
                scales = bundle.calibrate_q8(c, s)
                paths.append(("q8 B5", lambda: bundle.stylize_q8(c, s,
                                                                 scales)))
            # bf16, q8, q8, bf16 on B6: the policy's A/B in both orders
            again = [paths[1], paths[0]] if dt == "bfloat16" else []
            for i, (path, fn) in enumerate(paths + again):
                for label, attention in (attentions if i < len(paths)
                                         else attentions[:1]):
                    bundle.model.attention = attention
                    ms = cuda_ms(fn, iters=3, warmup=1)
                    log("28 sanet timing", f"stylize {IMG}px b{batch} "
                        f"{path:17s} attention {label:5s}: {ms:9.3f} ms "
                        f"{batch * 1e3 / ms:8.2f} img/s ({name_power})")
            del bundle
            torch.cuda.empty_cache()
    for batch in (1,):  # b4 cut for the time limit (PR 20)
        c, s = pair(batch)
        for dt in ("float32", "bfloat16"):
            # B6 only (the plain / SDPA steps are cut for the time limit;
            # phase 23 times B6 against both)
            for label, attention in attentions[:1]:
                bundle = _sanet_bundle(dev, IMG, compute_dtype=dt)
                bundle.model.attention = attention
                state = create_train_state(bundle)
                ms = cuda_ms(lambda: train_step(state, bundle.vgg, c, s),
                             iters=3, warmup=1)
                log("28 sanet timing", f"train step {IMG}px b{batch} {dt:8s} "
                    f"attention {label:5s}: {ms:9.3f} ms/step "
                    f"{batch * 1e3 / ms:8.2f} img/s ({name_power})")
                del state, bundle
                torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# slice 6b: the adaptive SANet (dynamic_sanet) and SourceNet (src)
# ---------------------------------------------------------------------------

DYN_FIXTURE = REPO / "tests" / "fixtures" / "torch_port_dynamic_sanet.npz"
SRC_FIXTURE = REPO / "tests" / "fixtures" / "torch_port_src.npz"
DYN_YAML = REPO / "configs" / "train_dynamic_sanet.yaml"
SRC_YAML = REPO / "configs" / "train_source_adain.yaml"
# the plans' B5 launches per q8 stylize (tests/test_torch_{dynamic_sanet,
# src}.py hold them on the CPU): dynamic_sanet conv_4 .. conv_13 of the 2N
# encode + mirror conv0 .. conv5; src conv_4 .. conv_9 + conv0 .. conv5. No
# network of the slice launches B6: the adaptive attention is plain PyTorch
B5_PER_6B = {"dynamic_sanet": 16, "src": 12}
# the adaptive attention's streamed O against its dense form on the card:
# the same float32 products, the scores summed by cuBLAS over other row
# counts: 1e-5 of max |O|
ADAPTIVE_O_REL = 1e-5
# the model streamed against dense at 512px, float32: rpst's own tolerance
# (tests/test_adaptive_blockwise.py: 1e-3)
ADAPTIVE_ROUTES_TOL = 1e-3


def _6b_weights(network, size, seed=0):
    from rpst_torch.bridge import (dynamic_sanet_weights_from_seed,
                                   src_weights_from_seed)
    return (dynamic_sanet_weights_from_seed(seed, size)
            if network == "dynamic_sanet" else src_weights_from_seed(seed))


def _6b_bundle(dev, network, size, seeded=True, **over):
    """A dynamic_sanet or src bundle on the repository's yaml (src with
    use_mask off, so that q8 serves) with its VGG set: seeded weights, or
    what the drivers seed without --weights."""
    from rpst_torch.bridge import from_flax_params
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.nn.blocks import init_torch_default
    yaml = DYN_YAML if network == "dynamic_sanet" else SRC_YAML
    extra = {} if network == "dynamic_sanet" else {"use_mask": False}
    cfg = load_config(str(yaml), dict(img_size=size, test_dir="", vgg="",
                                      **extra, **over))
    bundle = build_model(cfg, dev)
    if seeded:
        bundle.load_state_dict(from_flax_params(_6b_weights(network, size)))
    else:
        init_torch_default(bundle.model, cfg.seed)
    bundle.vgg, _ = build_vgg(cfg, dev)
    return bundle


def _port_grad_name(path):
    """rpst's leaf path -> the port's parameter name."""
    from rpst_torch.bridge import PSI_NAMES
    name = "." + path.replace("/", ".")
    for k, v in PSI_NAMES.items():
        name = name.replace(k, v)
    return name[1:].replace("kernel", "weight")


def _6b_fixtures(dev):
    """Phase 29: dynamic_sanet and src on the card against their JAX
    fixtures; the adaptive attention's streamed O against its dense form at
    full scale. Returns the worst streamed-vs-dense O error / max |O|."""
    import numpy as np
    import torch
    from rpst_torch.bridge import (from_flax_params, vgg_from_flax,
                                   vgg_weights_from_seed)
    from rpst_torch.models.fast_path_q8_std import sanet_q8_plan, src_q8_plan
    from rpst_torch.nn.vgg import VGG19Encoder
    from rpst_torch.ops.adaptive_attention import (
        adaptive_attention_dense, adaptive_reweighted_attention)
    msgs = []
    for network, path, over in (
            ("dynamic_sanet", DYN_FIXTURE, dict(content_weight=1.0,
                                                style_weight=3.0)),
            ("src", SRC_FIXTURE, dict(content_weight=1.0,
                                      style_weight=2.0))):
        with np.load(path) as npz:
            fx = {k: npz[k] for k in npz.files}
        size = fx["content"].shape[1]
        bundle = _6b_bundle(dev, network, size, **over)
        stages = bundle.vgg_stages
        vgg = VGG19Encoder(stages)
        vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
            int(fx["vgg_seed"]), stages)))
        bundle.vgg = vgg = vgg.to(dev)
        c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
        adaptive = network == "dynamic_sanet"
        plan = (sanet_q8_plan(vgg, bundle.q8_weights(), adaptive=True)
                if adaptive else src_q8_plan(vgg, bundle.q8_weights()))
        if plan != {"scales": len(fx["act_scales"]), "B5": B5_PER_6B[network],
                    "B6": 0}:
            raise AssertionError(f"{network} q8 plan {plan}")
        msg = []
        routes = ((("never", "out_f32"), ("always", "out_f32_always"))
                  if adaptive else (("-", "out_f32"),))
        for route, key in routes:
            if adaptive:
                bundle.model.transform.blockwise = route
            _reset_counts()
            out = bundle.stylize(c, s)
            torch.cuda.synchronize()
            if _counts(("B5", "B6a")) != (0, 0):
                raise AssertionError(f"{network} stylize launches "
                                     f"{_counts(('B5', 'B6a'))}")
            err, _ = check_close(f"{network} fixture {route} f32", out,
                                 torch.from_numpy(fx[key]).to(dev), F32_TOL)
            msg.append(f"{route} f32 max abs err {err:.3g}")
        if adaptive:
            bundle.model.transform.blockwise = "auto"
        scales = {"act_scales": fx["act_scales"]}
        for dt, key, min_psnr in ((torch.float32, "out_q8_f32",
                                   SANET_Q8_F32_PSNR),
                                  (torch.bfloat16, "out_q8_bf16",
                                   Q8_VS_FOLDED_PSNR)):
            _reset_counts()
            got = bundle.stylize_q8(c, s, scales, dtype=dt).cpu().numpy()
            n = _counts(("B5", "B6a"))
            psnr = _psnr(got, fx[key])
            if not (np.isfinite(got).all() and psnr >= min_psnr
                    and n == (plan["B5"], 0)):
                raise AssertionError(f"{network} fixture {key}: PSNR {psnr} "
                                     f"dB, B5 / B6 launches {n}")
            msg.append(f"{key} PSNR {psnr:.2f} dB (>= {min_psnr})")
        own = bundle.calibrate_q8(c, s)["act_scales"]
        if not np.allclose(own, fx["act_scales"], rtol=2e-2):
            raise AssertionError(f"{network} calibration {own} vs rpst "
                                 f"{fx['act_scales']}")
        _reset_counts()
        total, parts = bundle.loss(vgg, c, s)
        total.backward()
        torch.cuda.synchronize()
        if any(_counts(("B5", "B6a", "B6b", "B6c", "B6d"))):
            raise AssertionError(f"{network} loss launched a kernel")
        for k in parts:
            got, want = float(parts[k].detach()), float(fx[k])
            if not abs(got - want) <= LOSS_RTOL * abs(want):
                raise AssertionError(f"{network} fixture {k}: {got} vs rpst "
                                     f"{want}")
        worst = _check_sanet_grads(bundle.model, fx)
        log("29 6b fixtures", f"{network} 64px b2 vs rpst JAX: "
            f"{'; '.join(msg)}; {plan['B5']} B5 + 0 B6 per q8 stylize, "
            f"{plan['scales']} scales within 2e-2 of rpst's; total_loss "
            f"{float(parts['total_loss'].detach()):.7g} vs "
            f"{float(fx['total_loss']):.7g}, worst gradient err / max "
            f"{worst:.3g}")
        msgs.append(msg)
        del bundle
        torch.cuda.empty_cache()
    # the op at relu4_1 of a 512px stylize: streamed against dense
    g = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for variant in ("aea", "aea_lrelu"):
        # logits of standard deviation ~4 (the seeded model's, relu5_1):
        # the softmax peaks and P crosses the thresholds in some entries
        f, k, v = (torch.randn(1, 4096, 512, device=dev, generator=g) * 0.42
                   for _ in range(3))
        clamp = torch.rand(1, 4096, 1, device=dev, generator=g) * 0.6 + 0.3
        with torch.inference_mode():
            got = adaptive_reweighted_attention(f, k, v, clamp, variant)
            ref, prob, _ = adaptive_attention_dense(f, k, v, clamp, variant)
        crossed = (prob > clamp).float().mean().item()
        rel, mean_rel = check_scaled(f"adaptive attention {variant}", got,
                                     ref, ADAPTIVE_O_REL,
                                     ADAPTIVE_O_REL / 10)
        if not 0.0 < crossed < 0.5:
            raise AssertionError(f"adaptive attention {variant}: P > c in "
                                 f"{crossed} of the entries")
        worst = max(worst, rel)
        log("29 6b fixtures", f"adaptive attention {variant} (1, 4096, "
            f"4096, 512) f32, streamed (block 512) vs dense: max abs err "
            f"{rel:.3g}, mean {mean_rel:.3g} of max |O| "
            f"{ref.abs().max().item():.4g} (limit {ADAPTIVE_O_REL}); P > c in "
            f"{crossed:.2e} of the entries")
    return worst


def _6b_images(tmp, rng):
    import numpy as np
    from PIL import Image
    from rpst_torch.data import load_image
    for sub in ("content", "style"):
        (tmp / sub).mkdir(exist_ok=True)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                        "RGB").save(tmp / "content" / f"c{i}.png")
    Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                    "RGB").save(tmp / "style" / "s.png")
    return ([load_image(tmp / "content" / f"c{i}.png", IMG)
             for i in range(8)], load_image(tmp / "style" / "s.png", IMG))


def _6b_serve(dev, rng):
    """Phase 30: dynamic_sanet and src serving, standard and q8, through the
    user's entry points at 512px. Returns the in-process q8 runs' B5
    launches."""
    import numpy as np
    import torch
    from rpst_torch.serving import (DynamicBatcher, calibrate_scales,
                                    make_run_impl, resolve_mode)
    total_b5 = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        imgs, style_img = _6b_images(tmp, rng)
        for network in ("dynamic_sanet", "src"):
            bundle = _6b_bundle(dev, network, IMG, seeded=False)
            outs = {}
            for asked in ("standard", "q8"):
                mode = resolve_mode(bundle, asked, batch=4)
                if mode != asked:
                    raise AssertionError(f"{network} resolve_mode({asked}) = "
                                         f"{mode}")
                scales = None
                if mode == "q8":
                    calib = torch.from_numpy(np.stack(imgs[:4])).to(dev)
                    scales = calibrate_scales(bundle, calib, torch.from_numpy(
                        style_img)[None].to(dev).expand_as(calib)
                        .contiguous())
                batcher = DynamicBatcher(make_run_impl(bundle, mode, scales),
                                         batch_size=4, max_wait_ms=50.0,
                                         device=dev)
                _reset_counts()  # this main path's count starts here
                try:
                    outs[mode] = [f.result(timeout=600) for f in
                                  [batcher.submit(im, style_img)
                                   for im in imgs]]
                finally:
                    batcher.close()
                got = dict(zip(("B5", "B6"), _counts(("B5", "B6a"))))
                batches = batcher.stats()["batches"]
                want = {"B5": batches * B5_PER_6B[network] * (mode == "q8"),
                        "B6": 0}
                if got != want or batches < 2:
                    raise AssertionError(f"{network} {mode} main path: "
                                         f"launches {got} in {batches} "
                                         f"batches, expected {want}")
                for o in outs[mode]:
                    if o.shape != (IMG, IMG, 3) or not np.isfinite(o).all():
                        raise AssertionError(f"{network} {mode} output "
                                             f"{o.shape}")
                total_b5 += got["B5"]
                log("30 6b serve", f"{network} {mode}: 8 requests via "
                    f"DynamicBatcher(b4): {batcher.stats()}, launches {got} "
                    f"({batches} batches)")
            psnr = _psnr(np.stack(outs["q8"]), np.stack(outs["standard"]))
            if not psnr > Q8_VS_FOLDED_PSNR:
                raise AssertionError(f"{network} q8 vs standard f32: PSNR "
                                     f"{psnr} dB")
            log("30 6b serve", f"{network} q8 vs standard f32 PSNR "
                f"{psnr:.2f} dB (bound > {Q8_VS_FOLDED_PSNR})")
            del bundle, batcher
            torch.cuda.empty_cache()
            # the child: 8 PNGs in 2 batches, calibration first (no kernel)
            yaml = DYN_YAML if network == "dynamic_sanet" else SRC_YAML
            extra = ("--set", f"img_size={IMG}", "vgg=", "test_dir=",
                     *(() if network == "dynamic_sanet"
                       else ("use_mask=false",)))
            t0 = time.perf_counter()
            text, n_png = _serve_child(yaml, tmp, f"{network}_q8", "q8",
                                       extra)
            child = (_logged_count(text, "B5"), _logged_count(text, "B6"))
            n_scales = 16 if network == "dynamic_sanet" else 12
            if n_png != 8 or child != (2 * B5_PER_6B[network], 0) or \
                    f"Calibrated {n_scales} layer scales" not in text:
                raise AssertionError(f"serve_torch {network} q8: {n_png} "
                                     f"PNGs, B5 / B6 launches {child}:\n"
                                     f"{text[-3000:]}")
            rate = [ln for ln in text.splitlines() if "Stylized" in ln]
            log("30 6b serve", f"serve_torch.py {yaml.name} --mode q8: 8 "
                f"PNGs, B5 / B6 launches {child}, "
                f"{time.perf_counter() - t0:.1f}s wall; "
                f"{rate[-1].split(' - ')[-1] if rate else ''}")
    return total_b5


def _6b_train(dev):
    """Phase 31: train_torch.py on the repository's dynamic_sanet yaml
    (512px, batch 1, relu, float32; the streamed route, under autograd) and
    src yaml (512px, batch 8): 3 steps in this process, then a resume for 2
    more in this process, counts reset before and read after (no kernel on
    either path), peak device memory read over the resumed run."""
    import importlib.util
    import numpy as np
    import torch
    from rpst_torch.models.sanet import use_streamed

    if not (use_streamed("auto", dev, 4096, 4096)
            and use_streamed("auto", dev, 1024, 1024)):
        raise AssertionError("adaptive_blockwise auto does not stream at "
                             "512px on the card")
    spec = importlib.util.spec_from_file_location("train_torch",
                                                  REPO / "train_torch.py")
    train_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_cli)
    peaks = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "8", "--size", str(IMG)],
                       check=True, capture_output=True, timeout=300)
        for network, yaml, batch in (("dynamic_sanet", DYN_YAML, 1),
                                     ("src", SRC_YAML, 8)):
            out = tmp / network
            args = ["--config", str(yaml), "--device", "cuda", "--set",
                    f"img_size={IMG}", "vgg=", "test_dir=", "num_workers=4",
                    "log_iter=1", "snapshot_save_iter=2",
                    f"content_dir={tmp / 'corpus' / 'content'}",
                    f"style_dir={tmp / 'corpus' / 'style'}",
                    f"output={out}"]
            t0 = time.perf_counter()
            proc = _train_cli([*args, "max_iter=4"])
            text = proc.stdout + proc.stderr
            head = (f"Training {network} (standard, float32) on cuda")
            if proc.returncode != 0 or head not in text \
                    or f"batch {batch}, {IMG}px" not in text:
                raise AssertionError(f"train_torch.py {network} rc "
                                     f"{proc.returncode}:\n{text[-3000:]}")
            rates = [ln.split("img/s ")[1].split(",")[0]
                     for ln in text.splitlines() if "img/s" in ln]
            log("31 6b train", f"train_torch.py {yaml.name} b{batch} {IMG}px "
                f"f32, 3 steps in {time.perf_counter() - t0:.1f}s wall "
                f"(img/s per step {rates})")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            _reset_counts()  # the main path's count starts here
            train_cli.main([*args, "resume=true", "max_iter=3"])
            torch.cuda.synchronize()
            peaks[network] = torch.cuda.max_memory_allocated(dev)
            if any(_counts(("B1", "B2", "B3", "B5", "B6a", "B6b", "B6c",
                            "B6d"))):
                raise AssertionError(f"{network} training launched a kernel")
            lines = [json.loads(ln) for ln in
                     (out / "logs" / "metrics.jsonl").read_text()
                     .splitlines()]
            losses = [ln["total_loss"] for ln in lines]
            if [ln["step"] for ln in lines] != [1, 2, 3, 4, 5] \
                    or not np.isfinite(losses).all() \
                    or any(ln["skipped"] for ln in lines):
                raise AssertionError(f"{network} metrics.jsonl: {lines}")
            log("31 6b train", f"{network} resumed at step 3 for steps 4-5; "
                f"total_loss {[round(v, 4) for v in losses]}; no kernel "
                f"launched; peak device memory of the resumed run "
                f"{peaks[network] / 2 ** 30:.3f} GiB "
                f"(torch.cuda.max_memory_allocated)")
            torch.cuda.empty_cache()
    return peaks


def _6b_parity(dev, rng):
    """Phase 32: 512px b2, dynamic_sanet streamed against dense in float32
    and bfloat16; q8 against float32 for both networks."""
    import numpy as np
    import torch
    c, s = (torch.from_numpy(rng.random((2, IMG, IMG, 3), np.float32)).to(dev)
            for _ in range(2))
    msg = []
    for dt in ("float32", "bfloat16"):
        bundle = _6b_bundle(dev, "dynamic_sanet", IMG, compute_dtype=dt)
        outs = {}
        for route in ("never", "always"):
            bundle.model.transform.blockwise = route
            outs[route] = bundle.stylize(c, s)
        torch.cuda.synchronize()
        ref, got = outs["never"], outs["always"]
        span = float(ref.max() - ref.min())
        err = (got - ref).abs().max().item()
        if dt == "float32":
            check_close("512px dynamic_sanet streamed vs dense f32", got,
                        ref, ADAPTIVE_ROUTES_TOL)
        elif not (torch.isfinite(got).all() and err <= BF16_TOL * span):
            raise AssertionError(f"512px dynamic_sanet streamed vs dense "
                                 f"bf16: max abs err {err} > {BF16_TOL} x "
                                 f"span {span}")
        msg.append(f"dynamic_sanet streamed vs dense {dt}: max abs err "
                   f"{err:.3g} (span {span:.3g})")
        del bundle
        torch.cuda.empty_cache()
    for network in ("dynamic_sanet", "src"):
        bundle = _6b_bundle(dev, network, IMG)
        ref = bundle.stylize(c, s).cpu().numpy()
        scales = bundle.calibrate_q8(c, s)
        got = bundle.stylize_q8(c, s, scales).cpu().numpy()
        psnr = _psnr(got, ref)
        if not psnr > Q8_VS_FOLDED_PSNR:
            raise AssertionError(f"512px {network} q8 vs f32: PSNR {psnr} dB")
        msg.append(f"{network} q8 (bf16 around int8) vs f32 PSNR "
                   f"{psnr:.2f} dB")
        del bundle
        torch.cuda.empty_cache()
    log("32 6b parity", f"{IMG}px b2: {'; '.join(msg)}")


def _6b_timing(dev, rng, name_power):
    """Phase 33: 512px b1 stylize (b4 cut for the time limit, PR 20) of
    dynamic_sanet (streamed and dense; standard float32, bfloat16 and q8)
    and src (float32, bfloat16, q8), q8
    against bfloat16 in both orders (bf16, q8, q8, bf16); each network's
    train step at its config's batch. CUDA events, medians."""
    import numpy as np
    import torch
    from rpst_torch.train.step import create_train_state, train_step

    def pair(batch):
        return tuple(torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                                 np.float32)).to(dev)
                     for _ in range(2))

    for batch in (1,):  # b4 cut for the time limit (PR 20)
        c, s = pair(batch)
        for network in ("dynamic_sanet", "src"):
            routes = (("streamed", "always"), ("dense", "never")) \
                if network == "dynamic_sanet" else (("", None),)
            for route, blockwise in routes:
                for dt in ("float32", "bfloat16"):
                    bundle = _6b_bundle(dev, network, IMG, compute_dtype=dt)
                    if blockwise:
                        bundle.model.transform.blockwise = blockwise
                    paths = [(f"standard {dt}", lambda: bundle.stylize(c, s))]
                    if dt == "bfloat16":
                        scales = bundle.calibrate_q8(c, s)
                        paths.append(("q8 B5", lambda: bundle.stylize_q8(
                            c, s, scales)))
                    for path, fn in paths:  # one order: the time limit
                        ms = cuda_ms(fn, iters=3, warmup=1)
                        log("33 6b timing", f"stylize {IMG}px b{batch} "
                            f"{network} {route:8s} {path:17s}: {ms:9.3f} ms "
                            f"{batch * 1e3 / ms:8.2f} img/s ({name_power})")
                    del bundle
                    torch.cuda.empty_cache()
    for network, batch in (("dynamic_sanet", 1), ("src", 8)):
        c, s = pair(batch)
        bundle = _6b_bundle(dev, network, IMG)
        state = create_train_state(bundle)
        ms = cuda_ms(lambda: train_step(state, bundle.vgg, c, s), iters=3,
                     warmup=1)
        log("33 6b timing", f"train step {IMG}px b{batch} {network} float32: "
            f"{ms:9.3f} ms/step {batch * 1e3 / ms:8.2f} img/s ({name_power})")
        del state, bundle
        torch.cuda.empty_cache()


def _standard(bundle, c, s, dt):
    import torch
    with torch.autocast("cuda", dtype=torch.bfloat16,
                        enabled=dt == torch.bfloat16):
        return bundle.model(c, s)


def _logged_launches(text):
    """The count serve_torch.py logs as 'B1 fused_folded_conv launches: N'."""
    counts = [int(ln.rsplit(":", 1)[1]) for ln in text.splitlines()
              if "fused_folded_conv launches:" in ln]
    return counts[-1] if counts else None


def _daemon_round_trip(cfg_path, tmp, env):
    """Start serve_torch.py --daemon, send 6 requests, stats and shutdown
    over one connection; return (replies, stats). Always reaps the child."""
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "serve_torch.py"), "--config",
         str(cfg_path), "--content", str(tmp / "content"),
         "--style", str(tmp / "style" / "s.png"), "--out",
         str(tmp / "daemon"), "--mode", "folded", "--batch", "4",
         "--device", "cuda", "--daemon", "--port", "0",
         "--max-wait-ms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(REPO))
    try:
        port, lines = None, []
        deadline = time.time() + 300
        while time.time() < deadline and port is None:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "DAEMON LISTENING" in line:
                port = int(line.split("DAEMON LISTENING")[1].split()[0]
                           .rsplit(":", 1)[1])
        if port is None:
            raise AssertionError("daemon did not start:\n" + "".join(lines))
        with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
            f = s.makefile("rw")
            for i in range(6):
                f.write(json.dumps({"id": f"r{i}", "content": str(
                    tmp / "content" / f"c{i}.png")}) + "\n")
            f.flush()
            replies = [json.loads(f.readline()) for _ in range(6)]
            f.write(json.dumps({"cmd": "stats"}) + "\n")
            f.flush()
            stats = json.loads(f.readline())
            f.write(json.dumps({"cmd": "shutdown"}) + "\n")
            f.flush()
            if not json.loads(f.readline()).get("shutdown"):
                raise AssertionError("daemon did not acknowledge shutdown")
        rest, _ = proc.communicate(timeout=120)
        bad = [r for r in replies if not r.get("ok")
               or not Path(r["out"]).exists()]
        if bad or {r["id"] for r in replies} != {f"r{i}" for i in range(6)}:
            raise AssertionError(f"daemon replies: {replies}")
        if stats.get("served") != 6 or proc.returncode != 0:
            raise AssertionError(f"daemon stats {stats}, rc "
                                 f"{proc.returncode}:\n{rest[-2000:]}")
        if not (_logged_launches(rest) or 0) > 0:
            raise AssertionError(f"daemon logged no B1 launches:\n{rest}")
        return replies, stats
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# phases 34-38: slice 4 (sel_multi_adain, ccam, mst) and the target cache
# ---------------------------------------------------------------------------

CCAM_YAML = (REPO / "configs"
             / "train_constant_multiscale_rp_adain_channel_attention.yaml")
MST_YAML = REPO / "configs" / "train_constant_multiscale_rp_adain_global_mst.yaml"
S4_NETWORKS = ("sel_multi_adain", "ccam", "mst")
# the fixtures' configs (tools/make_torch_port_fixture.py SLICE4)
S4_FIXTURE_CFG = {
    "sel_multi_adain": dict(FLAGSHIP, network="sel_multi_adain"),
    "ccam": dict(FLAGSHIP, network="ccam", stylized_layers=5, shuffle=False),
    "mst": dict(FLAGSHIP, network="mst", stylized_layers=1, n_clusters=3,
                mst_lambda=0.0)}
S4_LOSS = dict(content_weight=1.0, style_weight=2.0)
# launches per call of each variant (rpst's code): a folded stylize runs the
# flagship's 15 RP layers on B1; a q8 stylize 3 B1 (the image layers) + 12
# B4 (B7 is the flagship's alone); calibration one float folded forward,
# 15 B1. A folded train step runs 23 / 17 / 15 B1 / B2 / B3 as the
# flagship's (the SE bottleneck's and CCAM's ops are not on B1); mst's
# transform detaches its inputs, so its encoder has no backward and its
# first decoder layer no input gradient: 23 / 8 (decoder layers 1-4 + the
# stylized VGG pass) / 5 (the decoder)
S4_STYLIZE_B1, S4_Q8, S4_CALIB_B1 = 15, {"B1": 3, "B4": 12, "B7": 0}, 15
S4_PER_STEP = {"sel_multi_adain": PER_STEP, "ccam": PER_STEP,
               "mst": (23, 8, 5)}
# a folded step whose loss targets come from the cache runs no VGG target
# pass: 4 B1 launches fewer
TCACHE_HIT_STEP = PER_STEP_Q8T
S4_Q8_F32_PSNR = 35.0  # as the other q8 fixtures on the card (phase 24)
# a gradient against rpst's: atol 1e-4 x max, or this many times the
# tensor's own float32 error in rpst (its folded gradient against its
# standard and its float64 ones) where that is more
# (test_torch_sel_multi_adain.py's rule, 2 there): ccam's float32 gradients
# on the card, through B1-B3 and through the standard path's cuDNN (no
# kernel of the port) alike, sit several times further off rpst's float64
# ones than rpst's float32 ones do (phase 34 prints both; PERF.md), so
# float32 on the card is held at 4
GRAD_SPREAD = 4.0
# the standard path's float64 gradients on the card against rpst's float64
# ones with float64 statistics (the fixtures' grads_f64s): the same function
# (5.9e-6 / 4.8e-8 / 3.7e-7 of max on the CPU for sel / ccam / mst); also the
# float32 bound's floor (phases 39 and 45's GRAD_ATOL_REL)
S4_STD_F64_ATOL = 1e-4
# a bfloat16 folded stylize against rpst's: MAE < 1e-2, or 3 x rpst's own
# bfloat16 distance from its float32 output where that is more (each
# framework's bf16 output sits about that far from the f32 one, in its own
# direction; ccam's CCAM softmax makes it 2.2e-2 at the fixture's point)
BF16_OWN = 3.0
TCACHE_FIXTURE = REPO / "tests" / "fixtures" / "torch_port_target_cache.npz"
# 512px bfloat16 against float32 (phase 35): 2x the flagship's budget; the
# variants' fusions re-normalize bf16 features at every scale
BF16_S4_MAE = 2e-2


def _s4_cfg(network, size, **over):
    """The variant's 512px serving / training config: bench.py:476-487's
    flagship widths for sel_multi_adain, the repository yaml for ccam and
    mst with ``shuffle: false`` (their test-time shuffle does not fold) and
    ``exec_strategy: folded``."""
    from rpst_torch.config import load_config
    base = dict(img_size=size, exec_strategy="folded", shuffle=False,
                test_dir="", vgg="", **over)
    if network in ("multi_adain", "sel_multi_adain"):
        return load_config(dict(FLAGSHIP, network=network, **base))
    return load_config(str(CCAM_YAML if network == "ccam" else MST_YAML),
                       base)


def _s4_fixture(network):
    import numpy as np
    from rpst_torch.bridge import flax_tree_from_npz
    with np.load(REPO / "tests" / "fixtures"
                 / f"torch_port_{network}.npz") as npz:
        trees = flax_tree_from_npz(npz)
        fx = {k: npz[k] for k in npz.files if "/" not in k}
    return fx, trees


def _s4_fixture_bundle(dev, network, fx, trees, **over):
    """The fixture's variant at its weights and VGG, on the card."""
    from rpst_torch.bridge import (from_flax_batch_stats, from_flax_params,
                                   vgg_from_flax, vgg_weights_from_seed)
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.vgg import VGG19Encoder
    cfg = load_config(dict(S4_FIXTURE_CFG[network],
                           img_size=fx["content"].shape[1],
                           exec_strategy="folded", lr=float(fx["lr"]),
                           lr_decay=float(fx["lr_decay"]), **S4_LOSS, **over))
    bundle = build_model(cfg, dev)
    params = {k: v for k, v in trees.items()
              if k not in ("batch_stats", "grads", "grads_std",
                           "grads_f64", "grads_f64s", "stats_after")}
    sd = from_flax_params(params)
    sd.update(from_flax_batch_stats(trees.get("batch_stats", {})))
    bundle.load_state_dict(sd)
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]))))
    return bundle, vgg.to(dev)


def _f64_err_ratio(model, ref, f64):
    """Median and max over the parameters of |grad - rpst's float64| over
    |rpst's float32 - rpst's float64| (each tensor's max norm), and the
    tensor of the max."""
    import numpy as np
    ratios = []
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        truth = f64[name].to(p.device)
        own = float((ref[name].to(p.device) - truth).abs().max())
        if own > 0.0:
            ratios.append((float((p.grad - truth).abs().max()) / own, name))
    top = max(ratios)
    return float(np.median([r for r, _ in ratios])), top[0], top[1]


def _s4_standard_grads(dev, network, fx, trees, vgg, c, s):
    """The standard path's gradients of the fixture's loss on the card in
    float32 (cuDNN, TF32 off) and in float64 (the feature statistics in
    float64, as grads_f64s), and the float32 backward under the profiler:
    {"model": the float32 model, "f32" / "f64": name -> gradient, "prof"}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for dt in (torch.float64, torch.float32):
        plain, _ = _s4_fixture_bundle(dev, network, fx, trees)
        plain.cfg = plain.cfg.replace(exec_strategy="standard")
        plain.model.to(dt).train()
        undo = _f64_stats() if dt == torch.float64 else (lambda: None)
        try:
            total = plain.loss(vgg.to(dt), c.to(dt), s.to(dt))[0]
            if dt == torch.float64:
                total.backward()
            else:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             record_shapes=True) as prof:
                    total.backward()
                    torch.cuda.synchronize()
                out["prof"], out["model"] = prof, plain.model
        finally:
            undo()
        out["f32" if dt == torch.float32 else "f64"] = {
            n: p.grad for n, p in plain.model.named_parameters()
            if p.grad is not None}
    vgg.float()
    return out


def _check_s4_standard(label, std, ref_std, f64s):
    """The standard path's gradients on the card against rpst's standard
    path, by phases 39 and 45's rule: its float64 gradients against rpst's
    float64 ones (grads_f64s) at S4_STD_F64_ATOL x max + 5e-3 x |value|;
    its float32 ones against rpst's standard float32 ones (grads_std) at
    S4_STD_F64_ATOL x max, or S5B_GRAD_SPREAD x the larger of the two
    frameworks' own float32 errors where that is more (each one's standard
    float32 gradient against its float64 one, over the max), + GRAD_RTOL x
    |value|; the port's own float32 error capped at S5B_MAX_OWN or twice
    rpst's worst over the network. A parameter without a gradient has
    rpst's zeros. Logs the three tensors of the largest own errors; raises
    after the log on any failed check. Returns a summary."""
    rows, bad = [], []
    live = [n for n in f64s if float(f64s[n].abs().max()) > 0.0]
    rpst_worst = max(float((ref_std[n].double() - f64s[n]).abs().max())
                     / float(f64s[n].abs().max()) for n in live)
    for name, truth in f64s.items():
        size = float(truth.abs().max())
        if name not in std["f64"]:
            if size != 0.0 or name in std["f32"]:
                bad.append(f"{name}: no float64 gradient, rpst's max {size}")
            continue
        truth = truth.to(std["f64"][name].device)
        g64, g32 = std["f64"][name], std["f32"][name].double()
        r32 = ref_std[name].to(truth.device).double()
        if size == 0.0:
            bad.append(f"{name}: rpst's float64 gradient is zero")
            continue
        e64 = float((g64 - truth).abs().max()) / size
        if not bool(((g64 - truth).abs() <= S4_STD_F64_ATOL * size
                     + 5e-3 * truth.abs()).all()):
            bad.append(f"{name} float64: max err {e64:.3g} x max")
        own_rpst = float((r32 - truth).abs().max()) / size
        own_port = float((g32 - g64).abs().max()) / size
        if own_port > max(S5B_MAX_OWN, 2 * rpst_worst):
            bad.append(f"{name}: the port's own float32 error "
                       f"{own_port:.3g}, rpst's worst {rpst_worst:.3g}")
        atol = max(S4_STD_F64_ATOL, S5B_GRAD_SPREAD * max(own_rpst, own_port))
        e32 = float((g32 - r32).abs().max()) / size
        if not bool(((g32 - r32).abs() <= atol * size
                     + GRAD_RTOL * r32.abs()).all()):
            bad.append(f"{name} float32: max err {e32:.3g} x max (atol "
                       f"{atol:.3g})")
        rows.append((own_port, name, e64, e32, own_rpst,
                     e32 / max(own_rpst, own_port, 1e-30)))
    if set(std["f32"]) != set(std["f64"]) or not set(std["f64"]) <= set(f64s):
        bad.append("gradients unchecked")
    rows.sort(reverse=True)
    log("34 slice-4 fixture", f"{label} standard path, largest own float32 "
        "errors (tensor: the port's own, rpst's own, float32 err, float64 "
        "err, over max): " + "; ".join(
            f"{n} {o:.3g} / {r:.3g} / {e32:.3g} / {e64:.3g}"
            for o, n, e64, e32, r, _ in rows[:3]) + f"; rpst's worst own "
        f"{rpst_worst:.3g}")
    if bad:
        raise AssertionError(f"{label} standard path: " + "; ".join(bad))
    return (f"standard path held: float64 worst err / max "
            f"{max(r[2] for r in rows):.3g} (limit {S4_STD_F64_ATOL}), "
            f"float32 {max(r[3] for r in rows):.3g} against rpst's standard "
            f"float32, at most {max(r[5] for r in rows):.3g} x the larger own "
            f"float32 error (limit {S5B_GRAD_SPREAD})")


def _standard_wgrad_kernels(std, name, ref, ref_std, f64s):
    """Parameter ``name``'s float32 errors on the standard path (the port's
    and rpst's standard path's against their float64 gradients, rpst's
    folded path's beside them, over the max) and the CUDA kernels of the
    profiled float32 backward's convolution_backward ops of its layer
    (matched by the layer weight's shape): the cuDNN algorithm that
    computes its gradient."""
    import collections
    size = float(f64s[name].abs().max())
    truth = f64s[name].to(std["f64"][name].device)

    def own(g):
        return float((g.to(truth.device).double() - truth).abs().max()) / size
    weight = name.rsplit(".", 1)[0] + ".weight"
    shape = list(std["f32"][weight if weight in std["f32"] else name].shape)
    kernels = collections.Counter()
    for ev in std["prof"].events():
        if ev.name != "aten::convolution_backward" or \
                shape not in [list(x) for x in ev.input_shapes if x]:
            continue
        stack = [ev]
        while stack:
            e = stack.pop()
            kernels.update(k.name[:90] for k in e.kernels)
            stack.extend(e.cpu_children)
    return (f"{name}: own float32 error over max, the port's standard "
            f"{float((std['f32'][name].double() - std['f64'][name]).abs().max()) / size:.3g}"
            f", rpst's standard {own(ref_std[name]):.3g}, rpst's folded "
            f"{own(ref[name]):.3g}; its layer's float32 convolution_backward "
            f"(weight {tuple(shape)}) runs " + ("; ".join(
                f"{k} x{n}" for k, n in kernels.most_common(4))
                or "no CUDA kernel recorded"))


def _check_s4_grads(label, model, ref, std, f64):
    """Every parameter's gradient against rpst's: rtol 5e-3 and atol 1e-4 x
    max, or GRAD_SPREAD x the tensor's own float32 error in rpst x max where
    that is more (the larger distance of rpst's folded gradient from its
    standard one and from its float64 one, over the tensor's max:
    test_torch_sel_multi_adain.py's rule); a parameter with no path from
    the loss has rpst's zeros. Returns the worst err / max and the worst
    err / own error."""
    import torch
    worst = ratio = 0.0
    for name, p in model.named_parameters():
        r = ref[name].to(p.device)
        size = float(r.abs().max())
        if p.grad is None:
            if size != 0.0:
                raise AssertionError(f"{label} {name}: no gradient, rpst's "
                                     f"max {size}")
            continue
        own = max(float((r - std[name].to(p.device)).abs().max()),
                  float((r - f64[name].to(p.device)).abs().max())) / size
        atol = max(GRAD_ATOL_REL, GRAD_SPREAD * own) * size
        err = float((p.grad - r).abs().max()) / size
        if not torch.allclose(p.grad, r, rtol=GRAD_RTOL, atol=atol):
            raise AssertionError(
                f"{label} {name}: max err {err * size} (max {size}, atol "
                f"{atol}, rpst's own error {own * size})")
        worst = max(worst, err)
        ratio = max(ratio, err / max(own, 1e-30))
    return worst, ratio


def _s4_fixtures(dev):
    """Phase 34: the three variants on the card against their JAX fixtures
    (folded f32 / standard / bf16 stylize, q8 with rpst's scales, loss
    parts, gradients, BatchNorm statistics, mst's labels), exact launches;
    then the target cache's losses and gradients against rpst's."""
    import numpy as np
    import torch
    from rpst_torch.bridge import from_flax_batch_stats, from_flax_params
    from rpst_torch.models.fast_path import _encode_folded
    from rpst_torch.ops.folded import unfold
    from rpst_torch.ops.kmeans import kmeans
    for network in S4_NETWORKS:
        fx, trees = _s4_fixture(network)
        bundle, vgg = _s4_fixture_bundle(dev, network, fx, trees)
        c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
        msg = []
        _reset_counts()
        out = bundle.stylize(c, s)
        torch.cuda.synchronize()
        if _counts(("B1", "B4")) != (S4_STYLIZE_B1, 0):
            raise AssertionError(f"{network} stylize launches "
                                 f"{_counts(('B1', 'B4'))}")
        err, _ = check_close(f"{network} folded f32", out,
                             torch.from_numpy(fx["out_folded"]).to(dev),
                             F32_TOL)
        std_out = bundle.stylize(c, s, folded=False)
        err_std, _ = check_close(f"{network} standard f32", std_out,
                                 torch.from_numpy(fx["out_std"]).to(dev),
                                 F32_TOL)
        msg.append(f"folded f32 {err:.3g}, standard {err_std:.3g} (tol "
                   f"{F32_TOL}), {S4_STYLIZE_B1} B1")
        b16, _ = _s4_fixture_bundle(dev, network, fx, trees,
                                    compute_dtype="bfloat16")
        out16 = b16.stylize(c, s).cpu().numpy()
        own = float(np.abs(fx["out_folded_bf16"] - fx["out_folded"]).mean())
        mae16 = float(np.abs(out16 - fx["out_folded_bf16"]).mean())
        if not mae16 < max(1e-2, BF16_OWN * own):
            raise AssertionError(f"{network} bf16 folded vs rpst bf16 MAE "
                                 f"{mae16} (rpst's own bf16 vs f32 {own})")
        msg.append(f"bf16 MAE {mae16:.3g} vs rpst's bf16 (bound "
                   f"{max(1e-2, BF16_OWN * own):.3g}), "
                   f"{float(np.abs(out16 - fx['out_folded']).mean()):.3g} "
                   "vs rpst's f32")
        scales = {"act_scales": fx["act_scales"]}
        for dt, key, limit in ((torch.float32, "out_q8_f32", S4_Q8_F32_PSNR),
                               (torch.bfloat16, "out_q8_bf16",
                                Q8_VS_FOLDED_PSNR)):
            _reset_counts()
            got = bundle.stylize_q8(c, s, scales, dtype=dt).cpu().numpy()
            n = _counts(Q8_KERNELS)
            psnr = _psnr(got, fx[key])
            if not (np.isfinite(got).all() and psnr >= limit and n == S4_Q8):
                raise AssertionError(f"{network} {key}: PSNR {psnr} dB, "
                                     f"launches {n}")
            msg.append(f"{key} {psnr:.2f} dB (>= {limit})")
        # the loss and its gradients, train mode (sel: batch statistics)
        bundle.model.train()
        _reset_counts()
        total, parts = bundle.loss(vgg, c, s)
        total.backward()
        torch.cuda.synchronize()
        if _counts() != S4_PER_STEP[network]:
            raise AssertionError(f"{network} loss launches {_counts()}, "
                                 f"expected {S4_PER_STEP[network]}")
        for k in ("content_loss", "style_loss", "total_loss"):
            got, want = float(parts[k].detach()), float(fx[k])
            if not abs(got - want) <= LOSS_RTOL * abs(want):
                raise AssertionError(f"{network} {k}: {got} vs rpst {want}")
        grads = [from_flax_params(trees[k])
                 for k in ("grads", "grads_std", "grads_f64")]
        worst, ratio = _check_s4_grads(network, bundle.model, *grads)
        # the standard path (cuDNN, no kernel of the port) in float32 and
        # float64 on the card, held by phases 39 / 45's rule against rpst's
        # float64 gradients with float64 statistics (grads_f64s)
        std = _s4_standard_grads(dev, network, fx, trees, vgg, c, s)
        f64s = from_flax_params(trees["grads_f64s"])
        held = _check_s4_standard(network, std, grads[1], f64s)
        f64_err = {k: _f64_err_ratio(m, grads[0], grads[2])
                   for k, m in (("folded", bundle.model),
                                ("standard", std["model"]))}
        msg.append(f"loss {float(total):.7g} vs {float(fx['total_loss']):.7g}"
                   f", worst gradient err / max {worst:.3g}, at most "
                   f"{ratio:.3g} x the tensor's own float32 error in rpst "
                   f"(limit {GRAD_SPREAD}); distance to rpst's float64 "
                   f"gradients over rpst's float32 one, median / max: "
                   f"folded (B1-B3) {f64_err['folded'][0]:.3g} / "
                   f"{f64_err['folded'][1]:.3g}, standard (cuDNN) "
                   f"{f64_err['standard'][0]:.3g} / "
                   f"{f64_err['standard'][1]:.3g} (at "
                   f"{f64_err['standard'][2]}); {held}; B1/B2/B3 "
                   f"{S4_PER_STEP[network]}")
        msg.append(_standard_wgrad_kernels(std, f64_err["standard"][2],
                                           grads[0], grads[1], f64s))
        del std
        if network == "sel_multi_adain":
            moved = from_flax_batch_stats(trees["stats_after"])
            bufs = dict(bundle.model.named_buffers())
            for k, v in moved.items():
                if not torch.allclose(bufs[k], v.to(dev), rtol=1e-5,
                                      atol=1e-6):
                    raise AssertionError(f"sel running statistic {k}")
            msg.append("moved BatchNorm statistics within 1e-5")
        if network == "mst":
            with torch.inference_mode():
                cf, sf = _encode_folded(bundle.folded_weights(torch.float32),
                                        c, s, torch.float32)
            for i in range(c.shape[0]):
                sfi = unfold(sf[-1])[i]
                labels, _ = kmeans(sfi.reshape(-1, sfi.shape[-1]).t(), 3)
                if not np.array_equal(labels.cpu().numpy(),
                                      fx["s_labels"][i]):
                    raise AssertionError(f"mst labels {labels} vs rpst "
                                         f"{fx['s_labels'][i]}")
            msg.append("deepest-scale k-means labels equal rpst's")
        log("34 slice-4 fixture", f"{network} 64px b2 vs rpst JAX: "
            f"{'; '.join(msg)}")
        del bundle, b16
    _tcache_fixture(dev)


def _tcache_fixture(dev):
    """The flagship's cached step (targets from DeviceTargetCache, a hit)
    against rpst's pretargets loss and gradients, and against the port's
    own recomputed step."""
    import numpy as np
    import torch
    from rpst_torch.bridge import (flax_tree_from_npz, from_flax_params,
                                   vgg_from_flax, vgg_weights_from_seed)
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.vgg import VGG19Encoder
    from rpst_torch.train.target_cache import DeviceTargetCache
    with np.load(REPO / "tests" / "fixtures" / "torch_port_train.npz") as npz:
        tree = flax_tree_from_npz(npz)
        fx = {k: npz[k] for k in npz.files if "/" not in k}
    tree.pop("grads")
    with np.load(TCACHE_FIXTURE) as npz:
        ref_tree = flax_tree_from_npz(npz)
        ref = {k: npz[k] for k in npz.files if "/" not in k}
    bundle = build_model(load_config(dict(
        FLAGSHIP, img_size=fx["content"].shape[1], exec_strategy="folded")),
        dev)
    bundle.load_state_dict(from_flax_params(tree))
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]))))
    vgg = vgg.to(dev)
    c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
    cache = DeviceTargetCache(c.shape[1], torch.float32, 4, 4, device=dev)
    cache.targets_for_batch(vgg, s, c, [0, 1], [0, 1])
    targets = cache.targets_for_batch(vgg, s, c, [0, 1], [0, 1])
    if cache.stats()["hit_steps"] != 1:
        raise AssertionError(f"target cache {cache.stats()}")
    runs = {}
    for label, t in (("cached", targets), ("recomputed", None)):
        bundle.model.zero_grad(set_to_none=True)
        _reset_counts()
        total, parts = bundle.loss(vgg, c, s, targets=t)
        total.backward()
        torch.cuda.synchronize()
        want = TCACHE_HIT_STEP if t is not None else PER_STEP
        if _counts() != want:
            raise AssertionError(f"{label} loss launches {_counts()}, "
                                 f"expected {want}")
        runs[label] = (parts, {n: p.grad.clone() for n, p in
                               bundle.model.named_parameters()})
    parts, grads = runs["cached"]
    for k in ("content_loss", "style_loss", "total_loss"):
        got = float(parts[k].detach())
        if not (abs(got - float(ref[k])) <= LOSS_RTOL * abs(float(ref[k]))
                and abs(got - float(runs["recomputed"][0][k].detach()))
                <= 1e-5 * abs(got)):
            raise AssertionError(f"cached {k} {got} vs rpst {ref[k]}")
    rgrads = from_flax_params(ref_tree["grads"])
    worst = 0.0
    for name, g in grads.items():
        r = rgrads[name].to(dev)
        size = float(r.abs().max())
        if not torch.allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * size):
            raise AssertionError(f"cached step gradient {name}")
        worst = max(worst, float((g - runs["recomputed"][1][name]).abs()
                                 .max()) / size)
    log("34 slice-4 fixture", f"target cache: the cached flagship step (64px "
        f"b2) vs rpst's pretargets loss (rtol {LOSS_RTOL}) and gradients, "
        f"B1/B2/B3 {TCACHE_HIT_STEP} against {PER_STEP} recomputed; cached "
        f"vs recomputed gradients {worst:.3g} of max")


def _mst_parity(bundle, c, s, folded, standard):
    """Phase 35's mst check: the deepest scale's k-means labels, folded
    against standard and bf16 against f32 (the flip shares), the fused
    features on the content channels whose matched cluster holds the same
    style channels in both layouts (all of them when no label flips), and
    the stylized output when no label flips; all at F32_TOL."""
    import torch
    from rpst_torch.models.fast_path import _encode_folded
    from rpst_torch.ops.folded import unfold
    from rpst_torch.ops.kmeans import kmeans
    from rpst_torch.ops.mst import mst_labels, mst_transfer_batch
    with torch.inference_mode():
        feats = {dt: _encode_folded(bundle.folded_weights(dt), c, s, dt)
                 for dt in (torch.float32, torch.bfloat16)}
        cf_std, sf_std, _ = bundle.model.ms.encode(c, s)
        cf_f, sf_f = (unfold(f[-1]) for f in feats[torch.float32])
        cf_s, sf_s = (f[-1].permute(0, 2, 3, 1) for f in (cf_std, sf_std))
        width = cf_f.shape[-1]
        flips = {"standard": 0, "bf16": 0}
        keep = []
        for i in range(cf_f.shape[0]):
            lab_f, match_f = mst_labels(cf_f[i].reshape(-1, width),
                                        sf_f[i].reshape(-1, width))
            lab_s, match_s = mst_labels(cf_s[i].reshape(-1, width),
                                        sf_s[i].reshape(-1, width))
            lab16 = kmeans(unfold(feats[torch.bfloat16][1][-1])[i]
                           .reshape(-1, width).t().float(), 3)[0]
            flips["standard"] += int((lab_s != lab_f).sum())
            flips["bf16"] += int((lab16 != lab_f).sum())
            members_f = lab_f[None, :] == match_f[:, None]
            members_s = lab_s[None, :] == match_s[:, None]
            keep.append((members_f == members_s).all(dim=1))
        keep = torch.stack(keep)                       # (N, C)
        if not bool(keep.any()):
            raise AssertionError("512 mst: no content channel's cluster "
                                 "agrees folded vs standard")
        fused_f = mst_transfer_batch(cf_f, sf_f)
        fused_s = mst_transfer_batch(cf_s, sf_s)
    n_ch = keep.numel()
    mask = keep[:, None, None, :].expand_as(fused_f)
    err, _ = check_close("mst fused folded vs standard", fused_f[mask],
                         fused_s[mask], F32_TOL)
    msg = (f"style-channel label flips folded vs standard "
           f"{flips['standard'] / n_ch:.3f}, bf16 vs f32 "
           f"{flips['bf16'] / n_ch:.3f} of {n_ch} channels; fused features "
           f"{err:.3g} on the {int(keep.sum())} of {n_ch} content channels "
           f"whose cluster agrees")
    if flips["standard"] == 0:
        out_err, mae = check_close("512 mst folded vs standard", folded,
                                   standard, F32_TOL)
        msg = (f"f32 folded vs standard max err {out_err:.3g}, MAE "
               f"{mae:.3g}; " + msg)
    else:
        msg += "; the output is not compared (labels flipped)"
    return msg


def _s4_parity(dev, rng):
    """Phase 35: 512px b2, each variant's folded path (B1) against its
    standard module, bf16 against f32, q8 against folded f32; mst's
    through ``_mst_parity``."""
    import numpy as np
    import torch
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    c = torch.from_numpy(rng.random((2, IMG, IMG, 3), np.float32)).to(dev)
    s = torch.from_numpy(rng.random((2, IMG, IMG, 3), np.float32)).to(dev)
    for network in S4_NETWORKS:
        cfg = _s4_cfg(network, IMG, compute_dtype="float32")
        bundle = build_model(cfg, dev)
        init_torch_default(bundle.model, cfg.seed)
        folded = bundle.stylize(c, s)
        standard = bundle.stylize(c, s, folded=False)
        torch.cuda.synchronize()
        msg = []
        if network == "mst":
            msg.append(_mst_parity(bundle, c, s, folded, standard))
        else:
            err, mae = check_close(f"512 {network} folded vs standard",
                                   folded, standard, F32_TOL)
            msg.append(f"f32 folded vs standard max err {err:.3g}, MAE "
                       f"{mae:.3g}")
        b16 = build_model(cfg.replace(compute_dtype="bfloat16"), dev)
        b16.load_state_dict(bundle.model.state_dict())
        out16 = b16.stylize(c, s)
        mae16 = (out16 - folded).abs().mean().item()
        if not (torch.isfinite(out16).all() and mae16 < BF16_S4_MAE):
            raise AssertionError(f"512 {network} bf16 vs f32 MAE {mae16}")
        scales = bundle.calibrate_q8(c, s)
        q8 = bundle.stylize_q8(c, s, scales).cpu().numpy()
        psnr = _psnr(q8, folded.cpu().numpy())
        if not psnr > Q8_VS_FOLDED_PSNR:
            raise AssertionError(f"512 {network} q8 vs f32 {psnr} dB")
        msg.append(f"bf16 vs f32 MAE {mae16:.3g}; q8 vs folded f32 "
                   f"{psnr:.2f} dB")
        log("35 slice-4 parity", f"512px b2 {network}: {'; '.join(msg)}")
        del bundle, b16
        torch.cuda.empty_cache()



# the serve_torch.py runs of phase 36: both modes of sel_multi_adain, ccam's
# q8 and mst's folded (cut from both modes of each and the ccam daemon for
# the time limit: the CLI code is one, and phases 6 and 62 drive the daemon)
S4_CLI_MODES = {"sel_multi_adain": ("folded", "q8"), "ccam": ("q8",),
                "mst": ("folded",)}


def _s4_serve(dev, rng):
    """Phase 36: sel_multi_adain's serving main path (8 requests through
    build_model -> resolve_mode -> [calibrate_scales ->] make_run_impl ->
    DynamicBatcher(b4), folded and q8, counts reset before and read after);
    serve_torch.py in the modes of ``S4_CLI_MODES``. Returns the in-process
    runs' B1 and B4 launches."""
    import numpy as np
    import torch
    from PIL import Image
    from rpst_torch.data import load_image
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.serving import (DynamicBatcher, calibrate_scales,
                                    make_run_impl, resolve_mode)
    total = {"B1": 0, "B4": 0}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for sub in ("content", "style"):
            (tmp / sub).mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                            "RGB").save(tmp / "content" / f"c{i}.png")
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                        "RGB").save(tmp / "style" / "s.png")
        imgs = [load_image(tmp / "content" / f"c{i}.png", IMG)
                for i in range(8)]
        style_img = load_image(tmp / "style" / "s.png", IMG)
        cfg = _s4_cfg("sel_multi_adain", IMG)
        bundle = build_model(cfg, dev)
        init_torch_default(bundle.model, cfg.seed)
        for asked in ("folded", "q8"):
            mode = resolve_mode(bundle, asked, batch=4)
            if mode != asked:
                raise AssertionError(f"sel resolve_mode({asked}) = {mode}")
            scales = None
            if mode == "q8":
                calib = torch.from_numpy(np.stack(imgs[:4])).to(dev)
                _reset_counts()
                scales = calibrate_scales(bundle, calib, torch.from_numpy(
                    style_img)[None].to(dev).expand_as(calib).contiguous())
                if (len(scales["act_scales"]) != 14
                        or _counts(("B1", "B4")) != (S4_CALIB_B1, 0)):
                    raise AssertionError(f"sel calibration: "
                                         f"{len(scales['act_scales'])} "
                                         f"scales, {_counts(('B1', 'B4'))}")
            batcher = DynamicBatcher(make_run_impl(bundle, mode, scales),
                                     batch_size=4, max_wait_ms=50.0,
                                     device=dev)
            _reset_counts()  # this main path's count starts here
            try:
                outs = [f.result(timeout=600) for f in
                        [batcher.submit(im, style_img) for im in imgs]]
            finally:
                batcher.close()
            got = dict(zip(("B1", "B4"), _counts(("B1", "B4"))))
            batches = batcher.stats()["batches"]
            per = ({"B1": S4_STYLIZE_B1, "B4": 0} if mode == "folded"
                   else {"B1": S4_Q8["B1"], "B4": S4_Q8["B4"]})
            want = {k: batches * v for k, v in per.items()}
            if got != want or batches < 2:
                raise AssertionError(f"sel {mode} main path: launches {got} "
                                     f"in {batches} batches, expected {want}")
            for o in outs:
                if o.shape != (IMG, IMG, 3) or not np.isfinite(o).all():
                    raise AssertionError(f"sel {mode} output {o.shape}")
            for k in total:
                total[k] += got[k]
            log("36 slice-4 serve", f"sel_multi_adain {mode}: 8 requests via "
                f"DynamicBatcher(b4): {batcher.stats()}, launches {got}")
        del bundle
        torch.cuda.empty_cache()
        for network in S4_NETWORKS:
            if network == "sel_multi_adain":
                cfg_path = tmp / "sel.yaml"
                cfg_path.write_text(json.dumps(dict(
                    FLAGSHIP, network=network, img_size=IMG)))
                extra = ()
            else:
                cfg_path = CCAM_YAML if network == "ccam" else MST_YAML
                extra = ("--set", f"img_size={IMG}", "shuffle=false",
                         "test_dir=", "vgg=")
            for mode, b1, b4 in (
                    ("folded", 2 * S4_STYLIZE_B1, 0),
                    ("q8", S4_CALIB_B1 + 2 * S4_Q8["B1"], 2 * S4_Q8["B4"])):
                if mode not in S4_CLI_MODES[network]:
                    continue
                t0 = time.perf_counter()
                text, n_png = _serve_child(cfg_path, tmp, f"{network}_{mode}",
                                           mode, extra)
                child = (_logged_count(text, "B1"), _logged_count(text, "B4"))
                if n_png != 8 or child != (b1, b4) or (
                        mode == "q8"
                        and "Calibrated 14 layer scales" not in text):
                    raise AssertionError(f"serve_torch {network} {mode}: "
                                         f"{n_png} PNGs, B1 / B4 {child}:\n"
                                         f"{text[-3000:]}")
                rate = [ln for ln in text.splitlines() if "Stylized" in ln]
                log("36 slice-4 serve", f"serve_torch.py {network} --mode "
                    f"{mode}: 8 PNGs, B1 / B4 launches {child}, "
                    f"{time.perf_counter() - t0:.1f}s wall; "
                    f"{rate[-1].split(' - ')[-1] if rate else ''}")
    return total


def _tcache_expected(n_imgs, batch, steps, seed):
    """(hit steps, miss steps) of rpst's whole-batch rule over the two
    loaders' key streams (``data.InfiniteSampler``, seeds seed and seed + 1;
    slots enough for every key)."""
    from rpst_torch.data import InfiniteSampler
    streams = (InfiniteSampler(n_imgs, seed), InfiniteSampler(n_imgs,
                                                                seed + 1))
    cached = (set(), set())
    hits = 0
    for _ in range(steps):
        keys = [[next(st) for _ in range(batch)] for st in streams]
        if all(k in c for ks, c in zip(keys, cached) for k in ks):
            hits += 1
        for ks, c in zip(keys, cached):
            c.update(ks)
    return hits, steps - hits


def _s4_train(dev):
    """Phase 37: train_torch.py for each variant at its settings (512px,
    folded; sel_multi_adain b4 f32, ccam and mst their yamls' b2 bf16): 3
    steps in this process, then a resume for 2 in this process, counts
    reset before and read after; sel_multi_adain's running statistics put
    back on a forced non-finite step; the flagship with ``target_cache:
    512`` on a corpus revisited within the run. Returns the in-process B1 /
    B2 / B3 launches."""
    import importlib.util
    import numpy as np
    import torch
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.train.step import create_train_state, train_step

    spec = importlib.util.spec_from_file_location("train_torch",
                                                  REPO / "train_torch.py")
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    total = [0, 0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "8", "--size", str(IMG)],
                       check=True, capture_output=True, timeout=300)
        corpus = [f"content_dir={tmp / 'corpus' / 'content'}",
                  f"style_dir={tmp / 'corpus' / 'style'}"]
        for network in S4_NETWORKS:
            out = tmp / f"run_{network}"
            if network == "sel_multi_adain":
                cfg_path = tmp / "sel_train.yaml"
                cfg_path.write_text(json.dumps(dict(
                    FLAGSHIP, network=network, img_size=IMG,
                    exec_strategy="folded", batch_size=4)))
                sets = []
            else:
                cfg_path = CCAM_YAML if network == "ccam" else MST_YAML
                # the yamls' checkpoint_path is a warm start that resume
                # would read: the run resumes from its own checkpoints
                sets = ["shuffle=false", "exec_strategy=folded", "vgg=",
                        "test_dir=", "checkpoint_path="]
            args = ["--config", str(cfg_path), "--device", "cuda", "--set",
                    *sets, f"img_size={IMG}", "num_workers=4", "log_iter=1",
                    "snapshot_save_iter=2", *corpus, f"output={out}"]
            per = S4_PER_STEP[network]
            t0 = time.perf_counter()
            proc = _train_cli([*args, "max_iter=4"])
            text = proc.stdout + proc.stderr
            child = [tuple(int(v) for v in ln.rsplit(":", 1)[1].split("/"))
                     for ln in text.splitlines()
                     if "B1/B2/B3 launches:" in ln]
            if proc.returncode != 0 or child != [tuple(3 * n for n in per)]:
                raise AssertionError(f"train_torch.py {network} rc "
                                     f"{proc.returncode}, launches {child}, "
                                     f"expected 3 x {per}:\n{text[-3000:]}")
            rates = [ln.split("img/s ")[1].split(",")[0]
                     for ln in text.splitlines() if "img/s" in ln]
            _reset_counts()  # the main path's count starts here
            driver.main([*args, "resume=true", "max_iter=3"])
            launches = _counts()
            if launches != tuple(2 * n for n in per):
                raise AssertionError(f"resumed {network} launches "
                                     f"{launches}, expected 2 x {per}")
            lines = [json.loads(ln) for ln in (out / "logs" / "metrics.jsonl")
                     .read_text().splitlines()]
            if [ln["step"] for ln in lines] != [1, 2, 3, 4, 5] or any(
                    ln["skipped"] or not np.isfinite(ln["total_loss"])
                    for ln in lines):
                raise AssertionError(f"{network} metrics.jsonl: {lines}")
            total = [a + b for a, b in zip(total, launches)]
            log("37 slice-4 train", f"train_torch.py {network} {IMG}px "
                f"folded: 3 steps in {time.perf_counter() - t0:.1f}s wall "
                f"(img/s per step {rates}), launches of the 3 steps "
                f"{child[0]}; "
                f"resumed for steps 4-5: B1/B2/B3 {launches} (2 x {per}), "
                f"total_loss {[round(ln['total_loss'], 5) for ln in lines]}")

        # sel_multi_adain's BatchNorm statistics across a skipped step
        cfg = _s4_cfg("sel_multi_adain", IMG, batch_size=2)
        bundle = build_model(cfg, dev)
        init_torch_default(bundle.model, cfg.seed)
        vgg, _ = build_vgg(cfg, dev)
        state = create_train_state(bundle)
        g = torch.Generator().manual_seed(0)
        c, s = (torch.rand(2, IMG, IMG, 3, generator=g).to(dev)
                for _ in range(2))
        train_step(state, vgg, c, s)
        before = [b.clone() for b in bundle.model.buffers()]
        bad = s.clone()
        bad[0, 0, 0, 0] = float("nan")
        skipped = float(train_step(state, vgg, c, bad)["skipped"])
        same = all(torch.equal(a, b) for a, b in
                   zip(bundle.model.buffers(), before))
        moved = float(train_step(state, vgg, c, s)["skipped"]) == 0.0 and \
            not all(torch.equal(a, b) for a, b in
                    zip(bundle.model.buffers(), before))
        if not (skipped == 1.0 and same and moved and len(before) == 6):
            raise AssertionError(f"sel skip: skipped {skipped}, statistics "
                                 f"kept {same}, moved after {moved}")
        log("37 slice-4 train", "sel_multi_adain b2: a non-finite step is "
            "skipped and its 6 BatchNorm running statistics stay bit-equal; "
            "the next finite step moves them")
        del bundle, state
        torch.cuda.empty_cache()

        # the flagship with the target cache: 8 images a side at b4
        out = tmp / "run_tcache"
        cfg_path = tmp / "tcache.yaml"
        steps = 7
        cfg_path.write_text(json.dumps(dict(
            FLAGSHIP, img_size=IMG, exec_strategy="folded", batch_size=4,
            max_iter=steps + 1, snapshot_save_iter=100, log_iter=1,
            num_workers=4, target_cache=512,
            content_dir=str(tmp / "corpus" / "content"),
            style_dir=str(tmp / "corpus" / "style"), output=str(out))))
        hits, misses = _tcache_expected(8, 4, steps, 0)
        _reset_counts()
        lines = []

        import logging

        class _Keep(logging.Handler):  # the driver's log lines
            def emit(self, record):
                lines.append(record.getMessage())

        from rpst_torch.metrics import logger
        keep = _Keep()
        logger.addHandler(keep)
        try:
            driver.main(["--config", str(cfg_path), "--device", "cuda"])
        finally:
            logger.removeHandler(keep)
        launches = _counts()
        want = tuple(misses * a + hits * b
                     for a, b in zip(PER_STEP, TCACHE_HIT_STEP))
        stats = [ln for ln in lines if "target_cache stats:" in ln]
        slot_line = [ln for ln in lines if "content slots" in ln]
        if (launches != want or not stats
                or f"'hit_steps': {hits}, 'miss_steps': {misses}"
                not in stats[-1]):
            raise AssertionError(f"target cache run: launches {launches} "
                                 f"(expected {want}), {stats}")
        total = [a + b for a, b in zip(total, launches)]
        log("37 slice-4 train", f"flagship b4 f32 target_cache 512: "
            f"{steps} steps, {stats[-1].split('stats: ')[1]} (the loaders' "
            f"key streams give {hits} hits / {misses} misses), B1/B2/B3 "
            f"{launches}; {slot_line[0] if slot_line else ''}")
    return tuple(total)


def _s4_timing(dev, rng, name_power):
    """Phase 38: 512px stylize b1 / b8 for each variant (folded B1,
    standard, q8 on B4; bf16, as the yamls serve, and f32 folded); each
    variant's train step at its settings; the flagship's b1 / b4 step, f32
    and bf16, with float targets, int8 targets and the cache hitting (one
    order each, for the script's time limit: the A/Bs of the policy
    table were taken in both orders)."""
    import numpy as np
    import torch
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.models.fast_path_q8_std import calibrate_vgg_targets_q8
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.train.step import create_train_state, train_step
    from rpst_torch.train.target_cache import DeviceTargetCache

    def img(n):
        return torch.from_numpy(rng.random((n, IMG, IMG, 3),
                                           np.float32)).to(dev)

    for network in S4_NETWORKS:
        cfg = _s4_cfg(network, IMG, compute_dtype="bfloat16")
        bundle = build_model(cfg, dev)
        init_torch_default(bundle.model, cfg.seed)
        f32 = build_model(cfg.replace(compute_dtype="float32"), dev)
        f32.load_state_dict(bundle.model.state_dict())
        for batch in (1, 8):
            c, s = img(batch), img(batch)
            scales = bundle.calibrate_q8(c, s)
            paths = {
                "folded f32": lambda: f32.stylize(c, s),
                "folded bf16": lambda: bundle.stylize(c, s),
                "standard bf16": lambda: bundle.stylize(c, s, folded=False),
                "q8 bf16": lambda: bundle.stylize_q8(c, s, scales)}
            # one order: the script's time limit
            order = ("folded bf16", "standard bf16", "q8 bf16", "folded f32")
            for path in order:
                ms = cuda_ms(paths[path], iters=3, warmup=1)
                log("38 slice-4 timing", f"{network} 512px b{batch} "
                    f"{path:13s}: {ms:8.3f} ms {batch * 1e3 / ms:8.2f} "
                    f"img/s ({name_power})")
        del bundle, f32
        torch.cuda.empty_cache()

    # the train step at each variant's settings, then the flagship's
    settings = [("sel_multi_adain", 4, "float32"),
                ("sel_multi_adain", 4, "bfloat16"), ("ccam", 2, "bfloat16"),
                ("mst", 2, "bfloat16")]
    for network, batch, dt in settings:
        cfg = _s4_cfg(network, IMG, compute_dtype=dt, batch_size=batch)
        bundle = build_model(cfg, dev)
        init_torch_default(bundle.model, cfg.seed)
        vgg, _ = build_vgg(cfg, dev)
        state = create_train_state(bundle)
        c, s = img(batch), img(batch)
        ms = cuda_ms(lambda: train_step(state, vgg, c, s), iters=3, warmup=1)
        log("38 slice-4 timing", f"{network} train step 512px b{batch} "
            f"{dt}: {ms:8.3f} ms {batch * 1e3 / ms:8.2f} img/s "
            f"({name_power})")
        del bundle, state
        torch.cuda.empty_cache()

    for batch in (1, 4):
        for dt in ("float32", "bfloat16"):
            cfg = _s4_cfg("multi_adain", IMG, compute_dtype=dt,
                          batch_size=batch)
            bundle = build_model(cfg, dev)
            init_torch_default(bundle.model, cfg.seed)
            vgg, _ = build_vgg(cfg, dev)
            state = create_train_state(bundle)
            c, s = img(batch), img(batch)
            cache = DeviceTargetCache(IMG, bundle.folded_dtype(), batch,
                                      batch, device=dev)
            keys = list(range(batch))
            cache.targets_for_batch(vgg, s, c, keys, keys)  # the one miss
            q8s = calibrate_vgg_targets_q8(vgg, c, s)

            def step(kind):
                bundle.q8_target_scales = q8s if kind == "int8" else None
                targets = (cache.targets_for_batch(vgg, s, c, keys, keys)
                           if kind == "cache" else None)
                return train_step(state, vgg, c, s, targets=targets)

            bundle.cfg = cfg.replace(train_q8_targets=True)
            for kind in ("float", "int8", "cache"):  # one order: time
                ms = cuda_ms(lambda: step(kind), iters=3, warmup=1)
                log("38 slice-4 timing", f"flagship train step 512px "
                    f"b{batch} {dt:8s} {kind:5s} targets: {ms:8.3f} ms "
                    f"{batch * 1e3 / ms:8.2f} img/s ({name_power})")
            del bundle, state, cache
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 39-43: slice 5b (mrf, spade, seg_adain) and wct training
# ---------------------------------------------------------------------------

S5B_NETWORKS = ("mrf", "spade", "seg_adain")
# the fixtures' configs (tools/make_torch_port_fixture.py SLICE5B) and their
# loss weights
S5B_FIXTURE_CFG = {
    "mrf": dict(WIDE, network="mrf", k=5, mrf_chunk=0, mrf_weight=1.0),
    "spade": dict(WIDE, network="spade", ndf=2, spade_norm="instance"),
    "seg_adain": dict(WIDE, network="seg_adain", seg_hidden_dim=32,
                      class_num=19, seg_loss_weight=1.0),
    "wct_train": dict(WIDE, network="wct")}
S5B_LOSS = dict(content_weight=1.0, style_weight=2.0)
# the act scales and B5 launches of one q8 stylize at bench.py's widths
# (rp_blocks 5, hidden 32; the plans, held on the CPU by
# tests/test_torch_{mrf,spade,seg_adain}.py): mrf each encoder's 128->256 and
# 256->512 (one pass each) and the decoder's 1024->512, 512->256, 256->128;
# spade its two encoders' (the SPADE generator is float); seg_adain adain's
# (the 2N encode's two, the decoder's two)
S5B_PLAN = {"mrf": {"scales": 9, "B5": 7}, "spade": {"scales": 6, "B5": 4},
            "seg_adain": {"scales": 5, "B5": 4}}
TRAIN_CONFIG_YAML = REPO / "configs" / "TrainConfig.yaml"
WCT_YAML = REPO / "configs" / "train_deeper_rp_wct.yaml"
# the fixtures' gradients (tests/test_torch_mrf.py's rule, GRAD_SPREAD 4 on
# the card as phase 34's): the port's float64 gradients against rpst's
# float64 ones at 1e-4 x max (wct 1e-3: both whiten in float32, and
# cuSOLVER's eigh moves the card's fused features from the CPU's: the
# decoder's float32 gradients read 6.7e-4 of max off rpst's); the float32
# ones at that floor or S5B_GRAD_SPREAD x the larger of the two frameworks'
# own float32 errors; the port's own capped at S5B_MAX_OWN or twice rpst's
# worst over the network; rpst's float64 gradient below S5B_ZERO x the
# largest is zero up to rounding (spade's biases before an instance norm),
# the port's then below S5B_NOISE x the largest
S5B_GRAD_SPREAD, S5B_MAX_OWN = 4.0, 3e-3
S5B_ZERO, S5B_NOISE = 1e-9, 1e-7
WCT_F64_ATOL = 1e-3
# 512px bfloat16 against float32 (phase 40): slice 4's budget
S5B_BF16_MAE = 2e-2
# the streamed MRF loss against its dense threshold form at 512px relu4_1
# (4096 positions): rpst's tolerance (tests/test_ops_affinity.py: 1e-4);
# chunked and whole similarity products may round a near-tie apart
MRF_STREAM_RTOL = 1e-4


def _5b_weights(network, seed=0):
    """The seeded params tree of a slice-5b network (bridge's draws)."""
    from rpst_torch import bridge
    width = dict(rp_blocks=WIDE["rp_blocks"], hidden_dim=WIDE["hidden_dim"])
    if network == "mrf":
        return bridge.mrf_weights_from_seed(seed, **width)
    if network == "spade":
        return bridge.spade_weights_from_seed(seed, ndf=2, **width)
    if network == "seg_adain":
        return bridge.seg_adain_weights_from_seed(seed, **width)
    return bridge.rpseq_weights_from_seed(seed, **width)


def _5b_bundle(dev, network, size, seeded=True, **over):
    """The network at bench.py's widths (the fixture's config for the
    fixture's name), seeded weights or the drivers' default init."""
    from rpst_torch.bridge import from_flax_params
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    cfg = load_config(dict(S5B_FIXTURE_CFG[network], img_size=size, vgg="",
                           test_dir="", **over))
    bundle = build_model(cfg, dev)
    if seeded:
        bundle.load_state_dict(from_flax_params(_5b_weights(network)))
    else:
        init_torch_default(bundle.model, cfg.seed)
    return bundle


def _5b_vgg(dev, seed):
    from rpst_torch.bridge import vgg_from_flax, vgg_weights_from_seed
    from rpst_torch.nn.vgg import VGG19Encoder
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(seed)))
    return vgg.to(dev)


def _5b_check_grads(label, g32, g64, fx, f64_atol):
    """The port's float32 and float64 gradients (name -> tensor) against a
    slice-5b fixture (the rule above the constants); returns (worst float32
    err / max, worst float64 err / max, zero-gradient tensors)."""
    import numpy as np
    keys = [k for k in fx if k.partition("/")[0] in ("grads", "gradpatch")]
    top = max(float(np.abs(fx[f"f64/{k}"]).max()) for k in keys)
    live = [k for k in keys
            if float(np.abs(fx[f"f64/{k}"]).max()) >= S5B_ZERO * top]
    rpst_worst = max(float(np.abs(fx[k] - fx[f"f64/{k}"]).max())
                     / float(np.abs(fx[f"f64/{k}"]).max()) for k in live)
    worst32 = worst64 = 0.0
    zero = 0
    names = set()
    for key in keys:
        kind, _, path = key.partition("/")
        name = path.replace("/", ".")
        # LD v5's upsampler kernels keep flax's name and (s, s, C, Co)
        # layout in the port; conv kernels become OIHW weights
        up = name.startswith("up_") and name.endswith(".kernel")
        if not up:
            name = name.replace("kernel", "weight")
        names.add(name)
        got, got64 = ((g if kind == "grads" else (
            g if up else g.permute(2, 3, 1, 0))[..., :8, :8]).double().cpu()
            .numpy() for g in (g32[name], g64[name]))
        ref, ref64 = fx[key], fx[f"f64/{key}"]
        if key not in live:
            if not (float(np.abs(got).max()) <= S5B_NOISE * top
                    and float(np.abs(got64).max()) <= S5B_ZERO * top):
                raise AssertionError(f"{label} {name}: a zero gradient reads "
                                     f"{np.abs(got).max()} / "
                                     f"{np.abs(got64).max()}")
            zero += 1
            continue
        size = float(np.abs(ref64).max())
        e64 = float(np.abs(got64 - ref64).max())
        if not np.all(np.abs(got64 - ref64)
                      <= f64_atol * size + 5e-3 * np.abs(ref64)):
            raise AssertionError(f"{label} {name} float64: max err {e64} "
                                 f"(max {size})")
        own_rpst = float(np.abs(ref - ref64).max()) / size
        own_port = float(np.abs(got - got64).max()) / size
        if own_port > max(S5B_MAX_OWN, 2 * rpst_worst):
            raise AssertionError(f"{label} {name}: the port's own float32 "
                                 f"error {own_port}, rpst's worst "
                                 f"{rpst_worst}")
        atol = max(f64_atol, S5B_GRAD_SPREAD * max(own_rpst, own_port))
        e32 = float(np.abs(got - ref).max())
        if not np.all(np.abs(got - ref) <= atol * size
                      + GRAD_RTOL * np.abs(ref)):
            raise AssertionError(f"{label} {name}: max err {e32} (max {size}"
                                 f", atol {atol * size})")
        worst32, worst64 = max(worst32, e32 / size), max(worst64, e64 / size)
    if names != set(g32):
        raise AssertionError(f"{label}: gradients unchecked "
                             f"{set(g32) - names}")
    return worst32, worst64, zero


def _5b_fixtures(dev):
    """Phase 39: mrf, spade, seg_adain and wct training on the card against
    their JAX fixtures: stylize f32 and bf16, q8 with rpst's scales and
    exact B5 launches, loss parts, gradients (float32 and float64) and the
    3-step trajectory (seg_adain with labels, wct with the encoder frozen,
    left bit-unchanged)."""
    import numpy as np
    import torch
    from rpst_torch.train.step import adam_count, create_train_state, \
        train_step
    for network in (*S5B_NETWORKS, "wct_train"):
        with np.load(REPO / "tests" / "fixtures"
                     / f"torch_port_{network}.npz") as npz:
            fx = {k: npz[k] for k in npz.files}
        size = fx["content"].shape[1]
        over = dict(lr=float(fx["lr"]), lr_decay=float(fx["lr_decay"]),
                    **S5B_LOSS)
        bundle = _5b_bundle(dev, network, size, **over)
        vgg = _5b_vgg(dev, int(fx["vgg_seed"]))
        c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
        kw = ({"content_label": torch.from_numpy(fx["label"]).to(dev)}
              if "label" in fx else {})
        msg = []
        if network != "wct_train":
            _reset_counts()
            out = bundle.stylize(c, s)
            torch.cuda.synchronize()
            err, _ = check_close(f"{network} fixture f32", out,
                                 torch.from_numpy(fx["out_f32"]).to(dev),
                                 F32_TOL)
            bf16 = _5b_bundle(dev, network, size, compute_dtype="bfloat16")
            got16 = bf16.stylize(c, s).cpu().numpy()
            own = float(np.abs(fx["out_bf16"] - fx["out_f32"]).mean())
            mae16 = float(np.abs(got16 - fx["out_bf16"]).mean())
            if not mae16 < max(1e-2, BF16_OWN * own) or _counts(("B5",))[0]:
                raise AssertionError(f"{network} fixture bf16 MAE {mae16} "
                                     f"(rpst's own {own}), B5 "
                                     f"{_counts(('B5',))}")
            msg.append(f"f32 max abs err {err:.3g}, bf16 MAE {mae16:.3g} "
                       f"(rpst's own bf16 distance {own:.3g})")
            plan = S5B_PLAN[network]
            if len(fx["act_scales"]) != plan["scales"]:
                raise AssertionError(f"{network}: {len(fx['act_scales'])} "
                                     f"scales, plan {plan}")
            scales = {"act_scales": fx["act_scales"]}
            for dt, key, min_psnr in ((torch.float32, "out_q8_f32",
                                       SANET_Q8_F32_PSNR),
                                      (torch.bfloat16, "out_q8_bf16",
                                       Q8_VS_FOLDED_PSNR)):
                _reset_counts()
                got = bundle.stylize_q8(c, s, scales, dtype=dt).cpu().numpy()
                n = _counts(("B5",))[0]
                psnr = _psnr(got, fx[key])
                if not (np.isfinite(got).all() and psnr >= min_psnr
                        and n == plan["B5"]):
                    raise AssertionError(f"{network} fixture {key}: PSNR "
                                         f"{psnr} dB, B5 launches {n}")
                msg.append(f"{key} PSNR {psnr:.2f} dB (>= {min_psnr}), "
                           f"{n} B5")
            own_scales = bundle.calibrate_q8(c, s)["act_scales"]
            if not np.allclose(own_scales, fx["act_scales"], rtol=2e-2):
                raise AssertionError(f"{network} calibration {own_scales} "
                                     f"vs rpst {fx['act_scales']}")
        grads = {}
        for dt in (torch.float32, torch.float64):
            b = _5b_bundle(dev, network, size, **over)
            b.model.to(dt).train()
            _reset_counts()
            total, parts = b.loss(vgg.to(dt), c.to(dt), s.to(dt), **kw)
            total.backward()
            if any(_counts(("B1", "B2", "B3", "B5"))):
                raise AssertionError(f"{network} loss launched a kernel")
            grads[dt] = {n: torch.zeros_like(p) if p.grad is None else p.grad
                         for n, p in b.model.named_parameters()}
            if dt == torch.float32:
                for k, v in parts.items():
                    got, want = float(v.detach()), float(fx[k])
                    if not abs(got - want) <= LOSS_RTOL * abs(want):
                        raise AssertionError(f"{network} {k}: {got} vs rpst "
                                             f"{want}")
            del b
        vgg = vgg.float()
        w32, w64, zero = _5b_check_grads(
            network, grads[torch.float32], grads[torch.float64], fx,
            WCT_F64_ATOL if network == "wct_train" else GRAD_ATOL_REL)
        frozen = ("encoder",) if network == "wct_train" else ()
        fresh = _5b_bundle(dev, network, size, **over)
        before = {k: v.clone() for k, v in fresh.model.state_dict().items()}
        state = create_train_state(fresh, freeze_prefixes=frozen)
        losses = [float(train_step(state, vgg, c, s, **kw)["total_loss"])
                  for _ in range(len(fx["trajectory"]))]
        rel = np.abs(np.asarray(losses) - fx["trajectory"]) \
            / np.abs(fx["trajectory"])
        if not (rel[0] <= LOSS_RTOL and (rel[1:] <= 1e-2).all()
                and adam_count(state.optimizer) == 3):
            raise AssertionError(f"{network} trajectory {losses} vs rpst "
                                 f"{fx['trajectory']}")
        if frozen:
            moved = [k for k, v in fresh.model.state_dict().items()
                     if k.startswith("encoder.")
                     and not torch.equal(v, before[k])]
            if moved:
                raise AssertionError(f"wct's frozen encoder moved: {moved}")
            msg.append("the frozen encoder bit-unchanged over 3 steps")
        log("39 5b fixtures", f"{network} 64px b2 vs rpst JAX: "
            f"{'; '.join(msg)}; loss parts within {LOSS_RTOL}; gradients "
            f"worst err / max {w32:.3g} (float32), {w64:.3g} (float64), "
            f"{zero} zero up to rounding; trajectory rel err "
            f"{[f'{r:.2g}' for r in rel]}")
        del bundle, state, fresh, grads
        torch.cuda.empty_cache()


def _mrf_streamed_vs_dense(dev, rng):
    """The MRF loss at 512px relu4_1 (4096 positions) on the seeded mrf's
    stylized image and a style image: the streamed route (row chunks of
    1024) against the dense threshold union computed whole, and the dense
    top-k route (lower index among exact ties, as rpst's) beside it."""
    import numpy as np
    import torch
    from rpst_torch.models.mrf_rp import mrf_loss
    from rpst_torch.ops import affinity as aff
    bundle = _5b_bundle(dev, "mrf", IMG)
    vgg = _5b_vgg(dev, 1)
    c, s = (torch.from_numpy(rng.random((1, IMG, IMG, 3), np.float32)).to(dev)
            for _ in range(2))
    with torch.no_grad():
        f, g = vgg(bundle.model(c, s))[-1], vgg(s)[-1]
        dense = float(mrf_loss(f, g, 5, 0))
        t0 = time.perf_counter()
        streamed = float(mrf_loss(f, g, 5, 1024))
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - t0
        _, h, w, ch = f.shape
        a, b = f[0].reshape(-1, ch), g[0].reshape(-1, ch)
        sim = aff.l2_normalize_channels(a[None])[0] \
            @ aff.l2_normalize_channels(b[None])[0].T
        row = torch.topk(sim, 5, dim=1).values[:, -1:]
        col = torch.topk(sim, 5, dim=0).values[-1:]
        union = (sim >= row) | (sim >= col)
        ref = float((union * aff.cal_dist(a.T, b.T)).sum()) / (h * w * 5)
        # entries at or above a k-th value beyond the k a row / column takes
        ties = int((sim >= row).sum() + (sim >= col).sum()) - 10 * h * w
    if not abs(streamed - ref) <= MRF_STREAM_RTOL * abs(ref):
        raise AssertionError(f"512px MRF streamed {streamed} vs its dense "
                             f"threshold form {ref}")
    return (f"mrf loss {IMG}px relu4_1 ({h * w} positions): streamed "
            f"(chunk 1024, {t_stream * 1e3:.1f} ms) {streamed:.7g} vs the "
            f"dense threshold union {ref:.7g} (rel "
            f"{abs(streamed - ref) / ref:.2g}, limit {MRF_STREAM_RTOL}), the "
            f"dense top-k route {dense:.7g} (rel {abs(dense - ref) / ref:.2g}"
            f"; {ties} entries tied at a k-th value beyond the k a row or "
            "column takes)")


def _5b_parity(dev, rng):
    """Phase 40: 512px b2 at bench.py's widths: q8 against float32 (> 30
    dB) and bfloat16 against float32 (MAE < 2e-2) for the three networks;
    the MRF loss streamed against dense; B5 at the mrf decoder head's
    1024 -> 512 against its plain version."""
    import numpy as np
    import torch
    from rpst_torch.ops.conv2d_q8 import (fused_conv2d_q8,
                                          fused_conv2d_q8_plain)
    c, s = (torch.from_numpy(rng.random((2, IMG, IMG, 3), np.float32)).to(dev)
            for _ in range(2))
    msg = []
    for network in S5B_NETWORKS:
        bundle = _5b_bundle(dev, network, IMG)
        ref = bundle.stylize(c, s).cpu().numpy()
        bf16 = _5b_bundle(dev, network, IMG, compute_dtype="bfloat16")
        mae = float(np.abs(bf16.stylize(c, s).cpu().numpy() - ref).mean())
        scales = bundle.calibrate_q8(c, s)
        got = bundle.stylize_q8(c, s, scales).cpu().numpy()
        psnr = _psnr(got, ref)
        if not (psnr > Q8_VS_FOLDED_PSNR and mae < S5B_BF16_MAE
                and np.isfinite(got).all()):
            raise AssertionError(f"512px {network}: q8 vs f32 PSNR {psnr} "
                                 f"dB, bf16 vs f32 MAE {mae}")
        msg.append(f"{network} q8 vs f32 {psnr:.2f} dB, bf16 vs f32 MAE "
                   f"{mae:.3g}")
        del bundle, bf16
        torch.cuda.empty_cache()
    msg.append(_mrf_streamed_vs_dense(dev, rng))
    x, k, sc = _b5_layer(np.random.default_rng(40), dev, 1, IMG, IMG, 1024,
                         512)
    parts = []
    with torch.inference_mode():
        for out_int8 in (True, False):
            _reset_counts()
            got = fused_conv2d_q8(x, k, sc, out_int8, 0.0, "zero")
            torch.cuda.synchronize()
            if _counts(("B5",))[0] != 1:
                raise AssertionError("B5 1024->512 did not launch")
            want = fused_conv2d_q8_plain(x, k, sc, out_int8, 0.0, "zero")
            _, d = _q8_compare(f"B5 1024->512 out_int8={out_int8}", got,
                               want)
            if not out_int8 and not torch.equal(got.view(torch.int16),
                                                want.view(torch.int16)):
                raise AssertionError("B5 1024->512 bf16 bits differ")
            parts.append(d)
    msg.append(f"B5 (1,512,512,1024->512) zero vs plain: "
               f"{'; '.join(parts)}, bf16 bits equal")
    log("40 5b parity", f"{IMG}px b2: {'; '.join(msg)}")


def _5b_serve(dev, rng):
    """Phase 41: the three networks' serving main paths at 512px (bench.py's
    widths): 8 requests through build_model -> resolve_mode ->
    [calibrate_scales ->] make_run_impl -> DynamicBatcher(b4), standard and
    q8, counts reset before and read after (q8: 7 / 4 / 4 B5 a batch); then
    serve_torch.py --mode q8 as a subprocess for each (spade at
    configs/TrainConfig.yaml, hidden 2, cut for the time limit: phase 42
    trains that yaml). Returns the in-process q8 runs' B5 launches."""
    import numpy as np
    import torch
    from rpst_torch.serving import (DynamicBatcher, calibrate_scales,
                                    make_run_impl, resolve_mode)
    total_b5 = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        imgs, style_img = _6b_images(tmp, rng)
        for network in S5B_NETWORKS:
            bundle = _5b_bundle(dev, network, IMG, seeded=False)
            outs = {}
            for asked in ("standard", "q8"):
                mode = resolve_mode(bundle, asked, batch=4)
                if mode != asked:
                    raise AssertionError(f"{network} resolve_mode({asked}) = "
                                         f"{mode}")
                scales = None
                if mode == "q8":
                    calib = torch.from_numpy(np.stack(imgs[:4])).to(dev)
                    scales = calibrate_scales(bundle, calib, torch.from_numpy(
                        style_img)[None].to(dev).expand_as(calib)
                        .contiguous())
                    if len(scales["act_scales"]) != \
                            S5B_PLAN[network]["scales"]:
                        raise AssertionError(f"{network} calibrated "
                                             f"{len(scales['act_scales'])}")
                batcher = DynamicBatcher(make_run_impl(bundle, mode, scales),
                                         batch_size=4, max_wait_ms=50.0,
                                         device=dev)
                _reset_counts()  # this main path's count starts here
                try:
                    outs[mode] = [f.result(timeout=600) for f in
                                  [batcher.submit(im, style_img)
                                   for im in imgs]]
                finally:
                    batcher.close()
                n_b5 = _counts(("B5",))[0]
                others = _counts(("B1", "B4", "B7", "B6a"))
                batches = batcher.stats()["batches"]
                want = batches * S5B_PLAN[network]["B5"] * (mode == "q8")
                if n_b5 != want or any(others) or batches < 2:
                    raise AssertionError(f"{network} {mode} main path: B5 "
                                         f"{n_b5} (want {want}), others "
                                         f"{others} in {batches} batches")
                for o in outs[mode]:
                    if o.shape != (IMG, IMG, 3) or not np.isfinite(o).all():
                        raise AssertionError(f"{network} {mode} output "
                                             f"{o.shape}")
                total_b5 += n_b5
                log("41 5b serve", f"{network} {mode}: 8 requests via "
                    f"DynamicBatcher(b4): {batcher.stats()}, {n_b5} B5 "
                    f"({batches} batches)")
            psnr = _psnr(np.stack(outs["q8"]), np.stack(outs["standard"]))
            if not psnr > Q8_VS_FOLDED_PSNR:
                raise AssertionError(f"{network} q8 vs standard f32: PSNR "
                                     f"{psnr} dB")
            log("41 5b serve", f"{network} q8 vs standard f32 PSNR "
                f"{psnr:.2f} dB (bound > {Q8_VS_FOLDED_PSNR})")
            del bundle, batcher
            torch.cuda.empty_cache()
        cases = [(network, None, (f"network={network}", "rp_blocks=5",
                                  "hidden_dim=32"),
                  S5B_PLAN[network]) for network in S5B_NETWORKS]
        for network, yaml, sets, plan in cases:
            cfg = yaml
            if cfg is None:
                cfg = tmp / f"{network}.yaml"
                cfg.write_text(json.dumps({"network": network}))
            t0 = time.perf_counter()
            text, n_png = _serve_child(
                cfg, tmp, f"{network}_{'yaml' if yaml else 'q8'}", "q8",
                ("--set", f"img_size={IMG}", "vgg=", "test_dir=", *sets))
            child = _logged_count(text, "B5")
            if n_png != 8 or child != 2 * plan["B5"] or \
                    f"Calibrated {plan['scales']} layer scales" not in text:
                raise AssertionError(f"serve_torch {network} q8: {n_png} "
                                     f"PNGs, B5 {child}:\n{text[-3000:]}")
            rate = [ln for ln in text.splitlines() if "Stylized" in ln]
            log("41 5b serve", f"serve_torch.py {network} "
                f"{yaml.name if yaml else 'bench widths'} --mode q8: 8 PNGs,"
                f" {plan['scales']} scales, B5 {child}, "
                f"{time.perf_counter() - t0:.1f}s wall; "
                f"{rate[-1].split(' - ')[-1] if rate else ''}")
    return total_b5


def _seg_dir(root, n, size):
    """Cityscapes side-by-side PNGs (content | gray raw ids 0 .. 33)."""
    import numpy as np
    from PIL import Image
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(42)
    for i in range(n):
        img = np.zeros((size, 2 * size, 3), np.uint8)
        img[:, :size] = rng.integers(0, 256, (size, size, 3), np.uint8)
        img[:, size:] = rng.integers(0, 34, (size, size, 1), np.uint8)
        Image.fromarray(img, "RGB").save(root / f"{i}.png")
    return root


def _5b_train(dev):
    """Phase 42: train_torch.py at 512px: mrf (mrf_weight 1), spade and
    seg_adain at bench.py's widths b1, spade at configs/TrainConfig.yaml,
    seg_adain on a synthetic side-by-side seg_dir, wct at
    configs/train_deeper_rp_wct.yaml (b4) with resume: true from the start
    (the encoder frozen): 3 steps in this process, then a resume for 2 in
    this process, counts reset before and read after (no kernel of the port
    runs), the resumed run's peak memory; the frozen encoder's bytes
    unchanged; a wct checkpoint saved without the freeze refused on resume.
    Returns the peaks."""
    import importlib.util
    import numpy as np
    import torch
    spec = importlib.util.spec_from_file_location("train_torch",
                                                  REPO / "train_torch.py")
    train_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_cli)
    peaks = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "8", "--size", str(IMG)],
                       check=True, capture_output=True, timeout=300)
        seg = _seg_dir(tmp / "seg", 4, IMG)
        wide = ("rp_blocks=5", "hidden_dim=32", "batch_size=1",
                "compute_dtype=float32")
        runs = [("mrf", None, (*wide, "network=mrf", "mrf_weight=1.0")),
                ("spade", None, (*wide, "network=spade")),
                ("seg_adain", None, (*wide, "network=seg_adain")),
                ("seg_adain seg_dir", None, (*wide, "network=seg_adain",
                                             f"seg_dir={seg}")),
                ("spade TrainConfig.yaml", TRAIN_CONFIG_YAML, ()),
                # the yaml's checkpoint_path names an adain run's checkpoint
                ("wct frozen", WCT_YAML, ("resume=true", "checkpoint_path="))]
        for label, yaml, sets in runs:
            cfg = yaml
            if cfg is None:
                cfg = tmp / f"{label.split()[0]}.yaml"
                cfg.write_text(json.dumps({}))
            out = tmp / label.replace(" ", "_").replace(".", "_")
            args = ["--config", str(cfg), "--device", "cuda", "--set",
                    f"img_size={IMG}", "vgg=", "test_dir=", "num_workers=4",
                    "log_iter=1", "snapshot_save_iter=2",
                    f"content_dir={tmp / 'corpus' / 'content'}",
                    f"style_dir={tmp / 'corpus' / 'style'}",
                    f"output={out}", *sets]
            t0 = time.perf_counter()
            proc = _train_cli([*args, "max_iter=4"])
            text = proc.stdout + proc.stderr
            if proc.returncode != 0 or "on cuda" not in text:
                raise AssertionError(f"train_torch.py {label} rc "
                                     f"{proc.returncode}:\n{text[-3000:]}")
            if "seg_dir" in label and "labelled content" not in text:
                raise AssertionError(f"{label}: no labelled content:\n"
                                     f"{text[-2000:]}")
            rates = [ln.split("img/s ")[1].split(",")[0]
                     for ln in text.splitlines() if "img/s" in ln]
            log("42 5b train", f"train_torch.py {label} {IMG}px, 3 steps in "
                f"{time.perf_counter() - t0:.1f}s wall (img/s per step "
                f"{rates})")
            first = torch.load(out / "checkpoints" / "3" / "state.pt",
                               map_location="cpu", weights_only=True)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            _reset_counts()  # the main path's count starts here
            train_cli.main([*args, "resume=true", "max_iter=3"])
            torch.cuda.synchronize()
            peaks[label] = torch.cuda.max_memory_allocated(dev)
            if any(_counts(("B1", "B2", "B3", "B4", "B5", "B6a", "B6b",
                            "B6c", "B6d"))):
                raise AssertionError(f"{label} training launched a kernel")
            lines = [json.loads(ln) for ln in
                     (out / "logs" / "metrics.jsonl").read_text()
                     .splitlines()]
            losses = [ln["total_loss"] for ln in lines]
            if [ln["step"] for ln in lines] != [1, 2, 3, 4, 5] \
                    or not np.isfinite(losses).all() \
                    or any(ln["skipped"] for ln in lines) \
                    or ("seg_dir" in label
                        and not all(ln["seg_loss"] > 0 for ln in lines)):
                raise AssertionError(f"{label} metrics.jsonl: {lines}")
            extra = ""
            if label.startswith("wct"):
                last = torch.load(out / "checkpoints" / "5" / "state.pt",
                                  map_location="cpu", weights_only=True)
                enc = [k for k in last["params"] if k.startswith("encoder.")]
                if not enc or any(not torch.equal(last["params"][k],
                                                  first["params"][k])
                                  for k in enc):
                    raise AssertionError("wct's frozen encoder moved")
                extra = (f"; the {len(enc)} encoder tensors bit-equal at "
                         "steps 3 and 5")
            log("42 5b train", f"{label} resumed at step 3 for steps 4-5; "
                f"total_loss {[round(v, 4) for v in losses]}; no kernel "
                f"launched; peak device memory of the resumed run "
                f"{peaks[label] / 2 ** 30:.3f} GiB "
                f"(torch.cuda.max_memory_allocated){extra}")
            torch.cuda.empty_cache()
        # wct without the freeze, then resumed: refused, as rpst refuses it
        out = tmp / "wct_plain"
        args = ["--config", str(WCT_YAML), "--device", "cuda", "--set",
                f"img_size={IMG}", "vgg=", "test_dir=", "num_workers=4",
                "snapshot_save_iter=2", "batch_size=1", "checkpoint_path=",
                f"content_dir={tmp / 'corpus' / 'content'}",
                f"style_dir={tmp / 'corpus' / 'style'}", f"output={out}"]
        train_cli.main([*args, "max_iter=3"])
        try:
            train_cli.main([*args, "resume=true", "max_iter=3"])
        except ValueError as e:
            if "without the freeze" not in str(e):
                raise
            log("42 5b train", f"wct resume of a checkpoint saved without "
                f"the freeze refused: {e}")
        else:
            raise AssertionError("wct resume of an unfrozen checkpoint was "
                                 "not refused")
    return peaks


def _5b_timing(dev, rng, name_power):
    """Phase 43: 512px b1 stylize of mrf, spade and seg_adain (bench.py's
    widths), float32, then bfloat16 against q8 in both orders (bf16, q8, q8,
    bf16); the train step b1 of the three and of wct (its yaml's widths),
    float32. CUDA events, medians."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.train.step import create_train_state, train_step

    def pair(batch):
        return tuple(torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                                 np.float32)).to(dev)
                     for _ in range(2))

    for batch in (1,):  # b4 cut for the time limit (PR 19's run has it)
        c, s = pair(batch)
        for network in S5B_NETWORKS:
            for dt in ("float32", "bfloat16"):
                bundle = _5b_bundle(dev, network, IMG, compute_dtype=dt)
                paths = [(f"standard {dt}", lambda: bundle.stylize(c, s))]
                if dt == "bfloat16":
                    scales = bundle.calibrate_q8(c, s)
                    paths.append(("q8 B5", lambda: bundle.stylize_q8(
                        c, s, scales)))
                for path, fn in paths:  # one order: the time limit
                    # spade's float32 generator: ~0.24 s an image
                    ms = cuda_ms(fn, iters=3 if network == "spade" else 5,
                                 warmup=1 if network == "spade" else 2)
                    log("43 5b timing", f"stylize {IMG}px b{batch} "
                        f"{network:9s} {path:17s}: {ms:9.3f} ms "
                        f"{batch * 1e3 / ms:8.2f} img/s ({name_power})")
                del bundle
                torch.cuda.empty_cache()
    c, s = pair(1)
    vgg = _5b_vgg(dev, 1)
    for network in (*S5B_NETWORKS, "wct"):
        if network == "wct":
            bundle = build_model(load_config(str(WCT_YAML), dict(
                img_size=IMG, vgg="", test_dir="")), dev)
            init_torch_default(bundle.model, 0)
        else:
            bundle = _5b_bundle(dev, network, IMG)
        state = create_train_state(bundle)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(lambda: train_step(state, vgg, c, s), iters=3, warmup=1)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log("43 5b timing", f"train step {IMG}px b1 {network} float32: "
            f"{ms:9.3f} ms/step {1e3 / ms:8.2f} img/s, peak {peak:.2f} GiB "
            f"({name_power})")
        del state, bundle
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 44-48: the LD family (ld_adain .. ld_adain5), B5's 7x7 form
# ---------------------------------------------------------------------------

LD_NETWORKS = ("ld_adain", "ld_adain2", "ld_adain3", "ld_adain4",
               "ld_adain5")
LD_Q8 = ("ld_adain", "ld_adain2")
LD_YAML = {n: REPO / "configs" / f"train_{t}_multiscale_rp_adain.yaml"
           for n, t in zip(LD_NETWORKS, ("ld", "ld2", "ld3", "ld4", "ld5"))}
# the fixtures' configs (tools/make_torch_port_fixture.py SLICE5B's LD
# entries: the yamls' widths, 5 layers, all stylized, use_mask off)
LD_FIXTURE_CFG = {n: dict(network=n, rp_blocks=5, ld_layer_num=5,
                          stylized_layers=5, inception_num=0, use_mask=False,
                          hidden_dim={"ld_adain": 16, "ld_adain2": 8}.get(
                              n, 32)) for n in LD_NETWORKS}
# one q8 stylize at the yamls' widths (held on the CPU by
# tests/test_torch_ld_q8.py): v1 layers 3 and 4 (a 3x3 and a 7x7 each) and
# decoder convs 0 and 1; v2 layer 4's small branch, conv_a and conv_b, and
# decoder conv 0
LD_PLAN = {"ld_adain": {"scales": 4, "B5": 6, "B5_7x7": 2},
           "ld_adain2": {"scales": 4, "B5": 4, "B5_7x7": 0}}
# LD v1's two 7x7 shapes at 512px: the 2N batch of one pair (b1) and of
# four (b4)
B5_7X7_SHAPES = (("LD v1 layer 3 7x7 128->128", (2, 512, 512, 128, 128)),
                 ("LD v1 layer 4 7x7 256->256", (2, 512, 512, 256, 256)),
                 ("LD v1 layer 3 7x7 128->128 b4", (8, 512, 512, 128, 128)),
                 ("LD v1 layer 4 7x7 256->256 b4", (8, 512, 512, 256, 256)))
# around the 7x7 form's tiles (16 x 16 pixels, 128 channels, clusters of
# two blocks): maps smaller than a tile and a grid smaller than a cluster (4
# x 4, 5 x 5, 5 x 4), one whole tile, ragged tiles both ways (17 x 33, 33 x
# 17, 4 x 37), Co off the 8-channel groups and the 128-channel block (4, 68,
# 132, 200, 260), C = 4 and 36 (a partial 32-byte chunk, rows not 16-byte
# aligned: word loads), N = 8, and C = 2048 (64 chunks, the exact int32
# sum's limit)
B5_7X7_EDGES = ((1, 4, 4, 4, 4), (2, 5, 5, 36, 68), (1, 17, 33, 128, 132),
                (2, 33, 17, 256, 200), (1, 4, 37, 64, 260), (3, 5, 4, 32, 4),
                (1, 16, 16, 32, 128), (8, 19, 21, 64, 136),
                (1, 6, 6, 2048, 8))
# rpst's int8 features against the card's: one step on under this share
LD_FEATURE_TIES = 1e-3


def _b5_layer7(rng, dev, n, h, w, c, co):
    """int8 x and (7, 7, C, Co) weights, scale rows near a real layer's."""
    import numpy as np
    import torch
    x = rng.integers(-127, 128, (n, h, w, c), dtype=np.int8)
    k = rng.integers(-127, 128, (7, 7, c, co), dtype=np.int8)
    sc = np.stack([rng.uniform(2e-6, 6e-6, co) * (128 / c) * (9 / 49),
                   rng.normal(0, 0.2, co),
                   rng.uniform(10.0, 40.0, co)]).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, k, sc))


def _ptxas_occupancy(log_text):
    """Blocks and warps per SM of the 7x7 kernel's two instances from
    ptxas's register counts (``-Xptxas -v``) and their dynamic shared memory
    (``b5_7x7_plan``): '' when the build was cached."""
    import re
    from rpst_torch.ops.conv2d_q8 import THREADS_7X7, b5_7x7_plan
    smem = b5_7x7_plan(1, 16, 16, 32, 128)["smem_bytes"]
    lines = log_text.splitlines()
    out = {}
    for i, ln in enumerate(lines):
        m = re.search(r"conv7x7_wgmma_kernelILb(\d)E", ln)
        if not m:
            continue
        regs = next((int(r.group(1)) for r in (
            re.search(r"Used (\d+) registers", x) for x in lines[i:i + 4])
            if r), None)
        threads = -(-THREADS_7X7 // 32) * 32
        blocks = min(65536 // (regs * threads) if regs else 0,
                     233472 // (smem + 1024))
        out[m.group(1)] = (f"{('bf16', 'int8')[int(m.group(1))]} out: {regs} "
                           f"registers x {THREADS_7X7} threads, {smem} B "
                           f"shared, {blocks} block(s) ({blocks * threads // 32}"
                           f" of 64 warps) a SM")
    return "; ".join(out.values())


def b5_7x7_checks(dev, name_power, timed=True):
    """B5's 7x7 form against its plain version: int8 and bf16 out, alpha
    0.2 and 0, at B5_7X7_EDGES and LD v1's two 512px shapes at N = 2 (int8
    out, alpha 0.2, at N = 8), each output compared bit for bit with the
    plain version and with a second run; the bytes its tiling stages from
    L2 (``b5_7x7_plan``) at each path shape; with ``timed`` each path shape
    timed raw (the C interface on fixed buffers), through the wrapper
    (packed weights kept, as the path keeps them), beside the plain version
    (N = 2), F.conv2d bf16 7x7 on the dequantized values (not the same
    function: no PyTorch call takes int8 on CUDA) and the bound of its int8
    operations. Returns (failed checks, the kernels line's numbers at (2,
    512, 512, 256 -> 256))."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from rpst_torch.kernels import build
    from rpst_torch.ops.conv2d_q8 import (b5_7x7_plan, fused_conv2d_q8,
                                          fused_conv2d_q8_plain,
                                          pack_conv2d_weights)
    rng = np.random.default_rng(44)
    out = {"err": 0.0}
    bad = 0

    def check(label, x, k, sc, out_int8, alpha):
        before = fused_conv2d_q8.launches_7x7
        got = fused_conv2d_q8(x, k, sc, out_int8, alpha, "reflect")
        again = fused_conv2d_q8(x, k, sc, out_int8, alpha, "reflect")
        torch.cuda.synchronize()
        ref = fused_conv2d_q8_plain(x, k, sc, out_int8, alpha, "reflect")
        bits = (lambda t: t.view(torch.int16)) if not out_int8 else \
            (lambda t: t)
        same = torch.equal(bits(got), bits(ref))
        stable = torch.equal(bits(got), bits(again))
        launched = fused_conv2d_q8.launches_7x7 - before == 2
        out["err"] = max(out["err"],
                         (got.float() - ref.float()).abs().max().item())
        if not (same and stable and launched):
            log("44 B5 7x7", f"{label}: FAILED (equal to plain {same}, "
                f"equal across runs {stable}, 7x7 launched {launched}; "
                f"{int((got != ref).sum())} of {got.numel()} differ)")
        return int(not (same and stable and launched))

    for shape in B5_7X7_EDGES:
        x, k, sc = _b5_layer7(rng, dev, *shape)
        n = sum(check(f"edge {shape} out_int8={o} alpha={a}", x, k, sc, o, a)
                for o in (True, False) for a in (0.2, 0.0))
        state = ("bit-equal to plain and across two runs" if not n
                 else f"{n} FAILED")
        log("44 B5 7x7", f"edge {shape}: int8 and bf16 out, alpha 0.2 and "
            f"0: {state}")
        bad += n
    occ = _ptxas_occupancy(build.build_info.get("conv2d_q8_7x7", {}).get(
        "log", ""))
    log("44 B5 7x7", f"occupancy (ptxas registers, the tile's shared "
        f"memory): {occ or 'not measured (cached build)'}")
    lib = build.load("conv2d_q8_7x7")
    for label, shape in B5_7X7_SHAPES:
        n_, h, w, c, co = shape
        x, k, sc = _b5_layer7(rng, dev, *shape)
        modes = ((True, 0.2), (True, 0.0), (False, 0.2), (False, 0.0)) \
            if n_ == 2 else ((True, 0.2),)
        nb = sum(check(f"{label} out_int8={o} alpha={a}", x, k, sc, o, a)
                 for o, a in modes)
        bad += nb
        plan = b5_7x7_plan(*shape)
        msg = f"{label} {shape}: " + (
            ("bit-equal to plain and across two runs, int8 and bf16 out, "
             "alpha 0.2 and 0" if n_ == 2 else "int8 out alpha 0.2 "
             "bit-equal to plain and across two runs") if not nb
            else f"{nb} FAILED") + (
            f"; L2 -> shared {plan['l2_bytes'] / 1e9:.3f} GB (weights "
            f"{plan['weight_bytes'] / 1e9:.3f}, halos "
            f"{plan['halo_bytes'] / 1e9:.3f}) over {plan['items']} "
            f"cluster work items, a grid of {plan['grid']} blocks")
        if timed:
            kp = pack_conv2d_weights(k)
            y = torch.empty((n_, h, w, co), device=dev, dtype=torch.int8)
            stream = torch.cuda.current_stream().cuda_stream

            def raw():
                err = lib.rpst_conv2d_q8_7x7(
                    x.data_ptr(), kp.data_ptr(), sc.data_ptr(), y.data_ptr(),
                    n_, h, w, c, co, 1, 0.2, stream)
                assert err == 0, err
            t_raw = cuda_ms(raw, iters=5, warmup=2)
            t_wrap = cuda_ms(lambda: fused_conv2d_q8(
                x, k, sc, True, 0.2, "reflect", w_packed=kp), iters=5,
                warmup=1)
            t_plain = cuda_ms(lambda: fused_conv2d_q8_plain(
                x, k, sc, True, 0.2, "reflect"), iters=2, warmup=1) \
                if n_ == 2 else None
            xd = (x.float() * 0.01).to(torch.bfloat16).permute(0, 3, 1, 2)
            wd = (k.float() * 0.01).to(torch.bfloat16).permute(3, 2, 0, 1) \
                .contiguous(memory_format=torch.channels_last)
            bd = sc[1].to(torch.bfloat16)
            t_lib = cuda_ms(lambda: F.conv2d(xd, wd, bd, padding=3),
                            iters=5, warmup=2)
            ops = 2 * 49 * n_ * h * w * c * co
            b_ms, b_by = bound_ms(ops, n_ * h * w * (c + co) + 49 * c * co
                                  + 3 * co * 4, "int8")
            msg += (f"; raw {t_raw:.4f} ms ({ops / t_raw / 1e9:.0f} TOP/s, "
                    f"{plan['l2_bytes'] / t_raw / 1e9:.2f} TB/s from L2), "
                    f"through the wrapper {t_wrap:.4f}, plain (float64) "
                    + (f"{t_plain:.2f}" if t_plain else "not timed at N = 8")
                    + f", F.conv2d bf16 7x7 {t_lib:.4f}; bound {b_ms:.4f} ms "
                    f"by {b_by} ({100 * b_ms / t_raw:.1f}% of it reached raw"
                    f"; {name_power})")
            if (n_, c) == (2, 256):
                out.update(ms=t_wrap, raw_ms=t_raw, plain_ms=t_plain,
                           library_ms=t_lib, bound_ms=b_ms, bound_by=b_by)
            del kp, y, xd, wd
        log("44 B5 7x7", msg)
        del x, k, sc
        torch.cuda.empty_cache()
    return bad, out


def _ld_kernels(dev, name_power):
    """Phase 44: B5's 7x7 form (b5_7x7_checks); raises on any failed
    check. The 3x3 form's checks are phase 17's, unchanged."""
    import torch
    with torch.inference_mode():
        bad, out = b5_7x7_checks(dev, name_power)
    if bad:
        raise AssertionError(f"B5 7x7: {bad} checks failed")
    return out


def _ld_bundle(dev, network, size, seeded=True, **over):
    """An LD network at its fixture's config (the yamls' widths), the
    weights of ``ld_weights_from_seed(network, 0)`` or the drivers' default
    init."""
    from rpst_torch.bridge import from_flax_params, ld_weights_from_seed
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    cfg = load_config(dict(LD_FIXTURE_CFG[network], img_size=size, vgg="",
                           test_dir="", **over))
    bundle = build_model(cfg, dev)
    if seeded:
        c = LD_FIXTURE_CFG[network]
        bundle.load_state_dict(from_flax_params(ld_weights_from_seed(
            network, 0, c["ld_layer_num"], c["hidden_dim"],
            c["stylized_layers"])))
    else:
        init_torch_default(bundle.model, cfg.seed)
    return bundle


def _f64_stats():
    """The port's feature statistics in float64 for a float64 run (the LD
    fixtures' float64 gradients take rpst's so: tools/
    make_torch_port_fixture.py ``ld_f64_stats``); returns the undo."""
    import torch
    from rpst_torch.models import base
    from rpst_torch.ops import stats

    def f64(feat, eps=1e-5):
        mean = feat.mean(dim=(1, 2), keepdim=True)
        n = feat.shape[1] * feat.shape[2]
        var = ((feat - mean) ** 2).sum(dim=(1, 2), keepdim=True) \
            / max(n - 1, 1)
        return mean, torch.sqrt(var + eps)
    old = stats.calc_mean_std, base.calc_mean_std
    stats.calc_mean_std = base.calc_mean_std = f64

    def undo():
        stats.calc_mean_std, base.calc_mean_std = old
    return undo


def _ld_counts():
    """(B5 launches, of them 7x7)."""
    from rpst_torch.ops.conv2d_q8 import fused_conv2d_q8
    return fused_conv2d_q8.launches, fused_conv2d_q8.launches_7x7


def _ld_fixtures(dev):
    """Phase 45: the five LD networks on the card against their JAX
    fixtures (32px b2, the yamls' widths): stylize f32 (1e-4) and bf16
    (MAE < 1e-2 or 3 x rpst's own bf16 distance); v1 / v2 q8 with rpst's
    scales (f32 >= 35 dB, bf16 >= 30) with exact B5 launches (6, two 7x7;
    4), calibration within 2e-2, the first eligible layer's int8 features
    on rpst's own int8 input (one step on under 1e-3 of them); loss
    parts (rtol 1e-4), gradients (float32, and float64 with the feature
    statistics in float64 as the fixture's), the 3-step trajectory."""
    import numpy as np
    import torch
    from rpst_torch.models.fast_path_q8 import _scale_rows
    from rpst_torch.ops.conv2d_q8 import fused_conv2d_q8
    from rpst_torch.train.step import adam_count, create_train_state, \
        train_step
    for network in LD_NETWORKS:
        with np.load(REPO / "tests" / "fixtures"
                     / f"torch_port_{network}.npz") as npz:
            fx = {k: npz[k] for k in npz.files}
        size = fx["content"].shape[1]
        over = dict(lr=float(fx["lr"]), lr_decay=float(fx["lr_decay"]),
                    **S5B_LOSS)
        bundle = _ld_bundle(dev, network, size, **over)
        vgg = _5b_vgg(dev, int(fx["vgg_seed"]))
        c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
        msg = []
        _reset_counts()
        out = bundle.stylize(c, s)
        torch.cuda.synchronize()
        err, _ = check_close(f"{network} fixture f32", out,
                             torch.from_numpy(fx["out_f32"]).to(dev), F32_TOL)
        bf16 = _ld_bundle(dev, network, size, compute_dtype="bfloat16")
        got16 = bf16.stylize(c, s).cpu().numpy()
        own = float(np.abs(fx["out_bf16"] - fx["out_f32"]).mean())
        mae16 = float(np.abs(got16 - fx["out_bf16"]).mean())
        if not mae16 < max(1e-2, BF16_OWN * own) or _counts(("B5",))[0]:
            raise AssertionError(f"{network} fixture bf16 MAE {mae16} "
                                 f"(rpst's own {own}), B5 {_counts(('B5',))}")
        msg.append(f"f32 max abs err {err:.3g}, bf16 MAE {mae16:.3g} (rpst's "
                   f"own bf16 distance {own:.3g})")
        if network in LD_Q8:
            plan = LD_PLAN[network]
            scales = {"act_scales": fx["act_scales"]}
            for dt, key, min_psnr in ((torch.float32, "out_q8_f32",
                                       SANET_Q8_F32_PSNR),
                                      (torch.bfloat16, "out_q8_bf16",
                                       Q8_VS_FOLDED_PSNR)):
                _reset_counts()
                got = bundle.stylize_q8(c, s, scales, dtype=dt).cpu().numpy()
                n = _ld_counts()
                psnr = _psnr(got, fx[key])
                if not (np.isfinite(got).all() and psnr >= min_psnr
                        and n == (plan["B5"], plan["B5_7x7"])):
                    raise AssertionError(f"{network} fixture {key}: PSNR "
                                         f"{psnr} dB, B5 launches {n}")
                msg.append(f"{key} PSNR {psnr:.2f} dB (>= {min_psnr}), "
                           f"{n[0]} B5 ({n[1]} 7x7)")
            own_scales = bundle.calibrate_q8(c, s)["act_scales"]
            if not np.allclose(own_scales, fx["act_scales"], rtol=2e-2):
                raise AssertionError(f"{network} calibration {own_scales} "
                                     f"vs rpst {fx['act_scales']}")
            enc_q, _ = bundle.q8_weights()
            act = [float(a) for a in fx["act_scales"]]
            x_q = torch.from_numpy(fx["q8_in"]).to(dev)
            layer = enc_q[int(fx["q8_layer"])]
            with torch.inference_mode():
                if network == "ld_adain":
                    feat = torch.cat([fused_conv2d_q8(
                        x_q, q.w_q, _scale_rows(act[0], q, act[1]), True, 0.2,
                        "reflect", w_packed=q.w_packed) for q in layer], -1)
                else:
                    q = layer[1]
                    feat = fused_conv2d_q8(x_q, q.w_q, _scale_rows(
                        act[1], q, act[2]), True, 0.0, "reflect",
                        w_packed=q.w_packed)
            diff = (feat.cpu().int() - torch.from_numpy(fx["q8_out"]).int()
                    ).abs()
            share = float((diff > 0).float().mean())
            if not (int(diff.max()) <= 1 and share < LD_FEATURE_TIES):
                raise AssertionError(f"{network} int8 features: max "
                                     f"{int(diff.max())} steps, {share} off")
            msg.append(f"int8 features of layer {int(fx['q8_layer'])} from "
                       f"rpst's int8 input: max {int(diff.max())} step, "
                       f"{share:.2g} of {diff.numel()} off (limit "
                       f"{LD_FEATURE_TIES})")
        grads = {}
        for dt in (torch.float32, torch.float64):
            b = _ld_bundle(dev, network, size, **over)
            b.model.to(dt).train()
            undo = _f64_stats() if dt == torch.float64 else (lambda: None)
            try:
                _reset_counts()
                total, parts = b.loss(vgg.to(dt), c.to(dt), s.to(dt))
                total.backward()
            finally:
                undo()
            if any(_counts(("B1", "B2", "B3", "B5"))):
                raise AssertionError(f"{network} loss launched a kernel")
            grads[dt] = {n: torch.zeros_like(p) if p.grad is None else p.grad
                         for n, p in b.model.named_parameters()}
            if dt == torch.float32:
                for k, v in parts.items():
                    got, want = float(v.detach()), float(fx[k])
                    if not abs(got - want) <= LOSS_RTOL * abs(want):
                        raise AssertionError(f"{network} {k}: {got} vs rpst "
                                             f"{want}")
            del b
        vgg = vgg.float()
        w32, w64, zero = _5b_check_grads(
            network, grads[torch.float32], grads[torch.float64], fx,
            GRAD_ATOL_REL)
        fresh = _ld_bundle(dev, network, size, **over)
        state = create_train_state(fresh)
        losses = [float(train_step(state, vgg, c, s)["total_loss"])
                  for _ in range(len(fx["trajectory"]))]
        rel = np.abs(np.asarray(losses) - fx["trajectory"]) \
            / np.abs(fx["trajectory"])
        if not (rel[0] <= LOSS_RTOL and (rel[1:] <= 1e-2).all()
                and adam_count(state.optimizer) == 3):
            raise AssertionError(f"{network} trajectory {losses} vs rpst "
                                 f"{fx['trajectory']}")
        log("45 LD fixtures", f"{network} {size}px b2 vs rpst JAX: "
            f"{'; '.join(msg)}; loss parts within {LOSS_RTOL}; gradients "
            f"worst err / max {w32:.3g} (float32), {w64:.3g} (float64), "
            f"{zero} zero up to rounding; trajectory rel err "
            f"{[f'{r:.2g}' for r in rel]}")
        del bundle, bf16, state, fresh, grads
        torch.cuda.empty_cache()


def _ld_serve(dev, rng):
    """Phase 46: each LD network's serving main path at 512px (the yamls'
    widths, default init): 4 requests through build_model -> resolve_mode
    -> [calibrate_scales ->] make_run_impl -> DynamicBatcher(b2), standard
    for the five and q8 for v1 / v2, counts reset before and read after
    (q8: 6 B5, two 7x7, and 4 B5 a batch; standard none); then
    serve_torch.py on the v1 and v2 yamls at b1 as a subprocess (--mode
    q8, v1 with use_mask=false). Returns the q8 runs' (B5, 7x7)
    launches."""
    import numpy as np
    import torch
    from rpst_torch.serving import (DynamicBatcher, calibrate_scales,
                                    make_run_impl, resolve_mode)
    total = [0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        imgs, style_img = _6b_images(tmp, rng)
        for network in LD_NETWORKS:
            bundle = _ld_bundle(dev, network, IMG, seeded=False)
            outs = {}
            for asked in ("standard", "q8") if network in LD_Q8 else \
                    ("standard",):
                mode = resolve_mode(bundle, asked, batch=2)
                if mode != asked:
                    raise AssertionError(f"{network} resolve_mode({asked}) = "
                                         f"{mode}")
                scales = None
                if mode == "q8":
                    calib = torch.from_numpy(np.stack(imgs[:2])).to(dev)
                    scales = calibrate_scales(bundle, calib, torch.from_numpy(
                        style_img)[None].to(dev).expand_as(calib)
                        .contiguous())
                    if len(scales["act_scales"]) != \
                            LD_PLAN[network]["scales"]:
                        raise AssertionError(f"{network} calibrated "
                                             f"{len(scales['act_scales'])}")
                batcher = DynamicBatcher(make_run_impl(bundle, mode, scales),
                                         batch_size=2, max_wait_ms=50.0,
                                         device=dev)
                _reset_counts()  # this main path's count starts here
                try:
                    outs[mode] = [f.result(timeout=600) for f in
                                  [batcher.submit(im, style_img)
                                   for im in imgs[:4]]]
                finally:
                    batcher.close()
                n = _ld_counts()
                others = _counts(("B1", "B4", "B7", "B6a"))
                batches = batcher.stats()["batches"]
                plan = LD_PLAN.get(network, {"B5": 0, "B5_7x7": 0})
                want = ((batches * plan["B5"], batches * plan["B5_7x7"])
                        if mode == "q8" else (0, 0))
                if n != want or any(others) or batches < 2:
                    raise AssertionError(f"{network} {mode} main path: B5 "
                                         f"{n} (want {want}), others "
                                         f"{others} in {batches} batches")
                for o in outs[mode]:
                    if o.shape != (IMG, IMG, 3) or not np.isfinite(o).all():
                        raise AssertionError(f"{network} {mode} output "
                                             f"{o.shape}")
                total = [total[0] + n[0], total[1] + n[1]]
                log("46 LD serve", f"{network} {mode}: 4 requests via "
                    f"DynamicBatcher(b2): {batcher.stats()}, {n[0]} B5 "
                    f"({n[1]} 7x7) in {batches} batches")
            if "q8" in outs:
                psnr = _psnr(np.stack(outs["q8"]), np.stack(outs["standard"]))
                if not psnr > Q8_VS_FOLDED_PSNR:
                    raise AssertionError(f"{network} q8 vs standard f32: "
                                         f"PSNR {psnr} dB")
                log("46 LD serve", f"{network} q8 vs standard f32 PSNR "
                    f"{psnr:.2f} dB (bound > {Q8_VS_FOLDED_PSNR})")
            del bundle, batcher
            torch.cuda.empty_cache()
        # serve_torch.py on the two q8 yamls only (v3-v5's standard serving
        # is the CLI's generic path, driven in-process above; cut for the
        # time limit)
        for network in LD_Q8:
            q8 = True
            sets = ("--set", f"img_size={IMG}", "vgg=", "test_dir=",
                    *(("use_mask=false",) if network == "ld_adain" else ()))
            t0 = time.perf_counter()
            text = _serve_cli(
                ["--config", str(LD_YAML[network]), "--content",
                 str(tmp / "content"), "--style", str(tmp / "style" / "s.png"),
                 "--out", str(tmp / f"out_{network}"), "--mode",
                 "q8" if q8 else "folded", "--batch", "1", "--device",
                 "cuda", *sets])
            n_png = len(list((tmp / f"out_{network}").glob("*.png")))
            b5, b7 = _logged_count(text, "B5"), _logged_7x7(text)
            plan = LD_PLAN.get(network)
            ok = n_png == 8 and (
                (b5 == 8 * plan["B5"] and b7 == 8 * plan["B5_7x7"]
                 and f"Calibrated {plan['scales']} layer scales" in text)
                if q8 else (b5 == 0 and "falling back to standard" in text))
            if not ok:
                raise AssertionError(f"serve_torch {network}: {n_png} PNGs, "
                                     f"B5 {b5} ({b7} 7x7):\n{text[-3000:]}")
            rate = [ln for ln in text.splitlines() if "Stylized" in ln]
            log("46 LD serve", f"serve_torch.py {LD_YAML[network].name} "
                f"--mode {'q8' if q8 else 'folded (standard)'} b1: 8 PNGs, "
                f"B5 {b5} ({b7} 7x7), {time.perf_counter() - t0:.1f}s wall; "
                f"{rate[-1].split(' - ')[-1] if rate else ''}")
    return total


def _logged_7x7(text):
    """The 7x7 count serve_torch.py / train_torch.py log."""
    counts = [int(ln.rsplit(":", 1)[1]) for ln in text.splitlines()
              if " - 7x7 B5 " in ln and " launches:" in ln]
    return counts[-1] if counts else None


def _ld_train(dev):
    """Phase 47: train_torch.py on each LD yaml's settings at 512px (their
    batch and type; lr as the yaml), 3 steps, then a resume for 2 more,
    both in this process through the driver's main, counts reset before and
    read after (no kernel of the port runs), the resumed run's peak device
    memory. Returns the peaks."""
    import importlib.util
    import numpy as np
    import torch
    spec = importlib.util.spec_from_file_location("train_torch",
                                                  REPO / "train_torch.py")
    train_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_cli)
    peaks = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "8", "--size", str(IMG)],
                       check=True, capture_output=True, timeout=300)
        for network in LD_NETWORKS:
            out = tmp / network
            args = ["--config", str(LD_YAML[network]), "--device", "cuda",
                    "--set", f"img_size={IMG}", "vgg=", "test_dir=",
                    "num_workers=4", "log_iter=1", "snapshot_save_iter=2",
                    f"content_dir={tmp / 'corpus' / 'content'}",
                    f"style_dir={tmp / 'corpus' / 'style'}",
                    f"output={out}"]
            t0 = time.perf_counter()
            _reset_counts()
            train_cli.main([*args, "max_iter=4"])
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            train_cli.main([*args, "resume=true", "max_iter=3"])
            torch.cuda.synchronize()
            peaks[network] = torch.cuda.max_memory_allocated(dev)
            if any(_counts(("B1", "B2", "B3", "B4", "B5", "B6a", "B6b",
                            "B6c", "B6d"))):
                raise AssertionError(f"{network} training launched a kernel")
            lines = [json.loads(ln) for ln in
                     (out / "logs" / "metrics.jsonl").read_text()
                     .splitlines()]
            losses = [ln["total_loss"] for ln in lines]
            if [ln["step"] for ln in lines] != [1, 2, 3, 4, 5] \
                    or not np.isfinite(losses).all() \
                    or any(ln["skipped"] for ln in lines):
                raise AssertionError(f"{network} metrics.jsonl: {lines}")
            log("47 LD train", f"train_torch.py {LD_YAML[network].name} "
                f"{IMG}px: 3 steps in {first:.1f}s wall, resumed at step 3 "
                f"for steps 4-5; total_loss "
                f"{[round(v, 4) for v in losses]}; no kernel launched; peak "
                f"device memory of the resumed run "
                f"{peaks[network] / 2 ** 30:.3f} GiB")
            torch.cuda.empty_cache()
    return peaks


def _ld_timing(dev, rng, name_power):
    """Phase 48: 512px stylize of the LD networks (the yamls' widths):
    b1 / b4 standard bfloat16 against q8 for v1 / v2 in both orders (bf16,
    q8, q8, bf16), v3-v5 bfloat16; v2's 2N encode against two passes at
    b1, b2 and b4 in both orders (2N, two, two, 2N); the train step at each
    yaml's batch and type, with its peak memory. CUDA events, medians of 3
    after 1."""
    import numpy as np
    import torch
    from rpst_torch import policy
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.train.step import create_train_state, train_step

    def pair(batch):
        return tuple(torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                                 np.float32)).to(dev)
                     for _ in range(2))

    for batch in (1, 4):
        c, s = pair(batch)
        for network in LD_NETWORKS:
            bundle = _ld_bundle(dev, network, IMG, compute_dtype="bfloat16")
            paths = [("standard bfloat16", lambda: bundle.stylize(c, s))]
            if network in LD_Q8:
                scales = bundle.calibrate_q8(c, s)
                paths.append(("q8 B5", lambda: bundle.stylize_q8(c, s,
                                                                 scales)))
            for path, fn in paths:  # one order: the time limit
                ms = cuda_ms(fn, iters=3, warmup=1)
                log("48 LD timing", f"stylize {IMG}px b{batch} {network:9s} "
                    f"{path:17s}: {ms:9.3f} ms {batch * 1e3 / ms:8.2f} img/s "
                    f"({name_power})")
            del bundle
            torch.cuda.empty_cache()
    old = policy.LD2_2N_ENCODE_MIN_BATCH
    try:
        for batch in (1, 2, 4):
            c, s = pair(batch)
            bundle = _ld_bundle(dev, "ld_adain2", IMG,
                                compute_dtype="bfloat16")
            for label, gate in (("2N encode", 1), ("two passes", 10 ** 9),
                                ("two passes", 10 ** 9), ("2N encode", 1)):
                policy.LD2_2N_ENCODE_MIN_BATCH = gate
                ms = cuda_ms(lambda: bundle.stylize(c, s), iters=3, warmup=1)
                log("48 LD timing", f"ld_adain2 {IMG}px b{batch} bfloat16 "
                    f"{label:10s}: {ms:9.3f} ms ({name_power})")
            del bundle
            torch.cuda.empty_cache()
    finally:
        policy.LD2_2N_ENCODE_MIN_BATCH = old
    vgg = _5b_vgg(dev, 1)
    for network in LD_NETWORKS:
        cfg = load_config(str(LD_YAML[network]), dict(img_size=IMG, vgg="",
                                                      test_dir=""))
        bundle = build_model(cfg, dev)
        init_torch_default(bundle.model, 0)
        c, s = pair(cfg.batch_size)
        state = create_train_state(bundle)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(lambda: train_step(state, vgg, c, s), iters=3, warmup=1)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log("48 LD timing", f"train step {IMG}px b{cfg.batch_size} "
            f"{network} {cfg.compute_dtype}: {ms:9.3f} ms/step "
            f"{cfg.batch_size * 1e3 / ms:8.2f} img/s, peak {peak:.2f} GiB "
            f"({name_power})")
        del state, bundle
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 49: adain training on the card
# ---------------------------------------------------------------------------

ADAIN_TRAIN_YAML = REPO / "configs" / "train_deeper_rp_adain.yaml"
# the fixture's network: the yaml's (tools/make_torch_port_fixture.py
# SLICE5B["adain_train"])
ADAIN_TRAIN_CFG = dict(network="adain", rp_blocks=5, hidden_dim=16)


def _adain_train(dev, name_power):
    """Phase 49: adain's training on the card against
    torch_port_adain_train.npz (the yaml's widths, 64px b2, seeded
    weights): loss parts (rtol 1e-4), float32 and float64 gradients by the
    slice-5b rule (_5b_check_grads: float64 1e-4 x max, float32 S5B_GRAD_SPREAD
    x the larger own error), the 3-step trajectory (1e-2), no kernel of the
    port launched; then the yaml's 512px b8 train step (test_dir cleared)
    timed in float32 and in its own bfloat16, with the peak device memory.
    CUDA events, medians of 3 after 1."""
    import numpy as np
    import torch
    from rpst_torch.bridge import from_flax_params, rpseq_weights_from_seed
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.train.step import adam_count, create_train_state, \
        train_step
    with np.load(REPO / "tests" / "fixtures"
                 / "torch_port_adain_train.npz") as npz:
        fx = {k: npz[k] for k in npz.files}
    size = fx["content"].shape[1]
    cfg = load_config(dict(ADAIN_TRAIN_CFG, img_size=size, vgg="",
                           test_dir="", lr=float(fx["lr"]),
                           lr_decay=float(fx["lr_decay"]), **S5B_LOSS))
    weights = from_flax_params(rpseq_weights_from_seed(
        int(fx["weights_seed"]), rp_blocks=ADAIN_TRAIN_CFG["rp_blocks"],
        hidden_dim=ADAIN_TRAIN_CFG["hidden_dim"]))

    def bundle():
        b = build_model(cfg, dev)
        b.load_state_dict(weights)
        return b
    vgg = _5b_vgg(dev, int(fx["vgg_seed"]))
    c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
    grads = {}
    for dt in (torch.float32, torch.float64):
        b = bundle()
        b.model.to(dt).train()
        _reset_counts()
        total, parts = b.loss(vgg.to(dt), c.to(dt), s.to(dt))
        total.backward()
        if any(_counts(("B1", "B2", "B3", "B5"))):
            raise AssertionError("adain's loss launched a kernel")
        grads[dt] = {n: torch.zeros_like(p) if p.grad is None else p.grad
                     for n, p in b.model.named_parameters()}
        if dt == torch.float32:
            for k, v in parts.items():
                got, want = float(v.detach()), float(fx[k])
                if not abs(got - want) <= LOSS_RTOL * abs(want):
                    raise AssertionError(f"adain {k}: {got} vs rpst {want}")
        del b
    vgg = vgg.float()
    w32, w64, zero = _5b_check_grads("adain_train", grads[torch.float32],
                                     grads[torch.float64], fx, GRAD_ATOL_REL)
    state = create_train_state(bundle())
    losses = [float(train_step(state, vgg, c, s)["total_loss"])
              for _ in range(len(fx["trajectory"]))]
    rel = np.abs(np.asarray(losses) - fx["trajectory"]) \
        / np.abs(fx["trajectory"])
    if not (rel[0] <= LOSS_RTOL and (rel[1:] <= 1e-2).all()
            and adam_count(state.optimizer) == 3):
        raise AssertionError(f"adain trajectory {losses} vs rpst "
                             f"{fx['trajectory']}")
    log("49 adain train", f"adain (rp_blocks 5, hidden 16) {size}px b2 vs "
        f"rpst JAX: loss parts within {LOSS_RTOL}; gradients worst err / "
        f"max {w32:.3g} (float32), {w64:.3g} (float64), {zero} zero up to "
        f"rounding; trajectory rel err {[f'{r:.2g}' for r in rel]}; no "
        "kernel of the port")
    del state, grads
    vgg = _5b_vgg(dev, 1)
    rng = np.random.default_rng(49)
    for dt in ("float32", "bfloat16"):
        cfg = load_config(str(ADAIN_TRAIN_YAML), dict(
            img_size=IMG, vgg="", test_dir="", compute_dtype=dt))
        b = build_model(cfg, dev)
        init_torch_default(b.model, 0)
        c, s = (torch.from_numpy(rng.random((cfg.batch_size, IMG, IMG, 3),
                                            np.float32)).to(dev)
                for _ in range(2))
        state = create_train_state(b)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        ms = cuda_ms(lambda: train_step(state, vgg, c, s), iters=3, warmup=1)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if any(_counts(("B1", "B2", "B3", "B5"))):
            raise AssertionError("adain's train step launched a kernel")
        log("49 adain train", f"train step {ADAIN_TRAIN_YAML.name} {IMG}px "
            f"b{cfg.batch_size} {dt}: {ms:9.3f} ms/step "
            f"{cfg.batch_size * 1e3 / ms:8.2f} img/s, peak {peak:.2f} GiB "
            f"({name_power})")
        del state, b, c, s
        torch.cuda.empty_cache()


# ---- 50-53. slice 7: masks, SE attention, the test dumps ------------------
MASKS_FIXTURE = REPO / "tests" / "fixtures" / "torch_port_masks.npz"
FLAGSHIP_YAML = REPO / "configs" / "train_constant_multiscale_rp_adain.yaml"
RECON_YAML = (REPO / "configs"
              / "train_constant_multiscale_rp_adain_recon.yaml")
# the bfloat16 rule of tests/test_torch_masks.py: MAE < 1e-2, or 3 x rpst's
# own bfloat16 distance from its float32 output where that is more
MASK_BF16_MAE, MASK_BF16_OWN = 1e-2, 3.0
# the SE flagship's float32 gradients: 4 x the tensor's own float32 error in
# rpst (its float32 gradient from its float64 one) on the card, as phases
# 34 / 39 / 45 hold theirs (2 x on the CPU)
MASK_GRAD_SPREAD = 4.0
# a folded flagship stylize launches B1 on its 15 RP layers (phase 3)
B1_PER_STYLIZE = 15


def _tool(name):
    """A module of tools/ (numpy and PIL only) by file name."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name,
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _npz_tree(fx, prefix):
    """The flax tree of a fixture's ``prefix`` keys (``a/b/c`` paths)."""
    tree = {}
    for key, value in fx.items():
        if key.startswith(prefix):
            node = tree
            *parents, leaf = key[len(prefix):].split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = value
    return tree


def _mask_case_bundle(dev, fx, case, dtype):
    """A masks-fixture case's bundle on the card in ``dtype``: its config
    (stored in the fixture), its weights (stored, or the ``bridge`` draw of
    the stored seed), the feature models' 4-stage VGG from ``vgg_seed``."""
    from rpst_torch import bridge
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    cfg = json.loads(str(fx[f"{case}/config"]))
    cfg = load_config(dict(cfg, img_size=fx["content"].shape[1],
                           compute_dtype=dtype))
    if f"{case}/weights_seed" in fx:
        seed = int(fx[f"{case}/weights_seed"])
        tree = {"src": lambda: bridge.src_weights_from_seed(seed),
                "seg_adain": lambda: bridge.seg_adain_weights_from_seed(
                    seed, seg_hidden_dim=cfg.seg_hidden_dim,
                    class_num=cfg.class_num, rp_blocks=cfg.rp_blocks,
                    hidden_dim=cfg.hidden_dim),
                "ld_adain": lambda: bridge.ld_weights_from_seed(
                    case, seed, cfg.ld_layer_num, cfg.hidden_dim,
                    cfg.stylized_layers)}[case]()
        sd = bridge.from_flax_params(tree)
    else:
        sd = {**bridge.from_flax_params(_npz_tree(fx, f"{case}/params/")),
              **bridge.from_flax_batch_stats(
                  _npz_tree(fx, f"{case}/batch_stats/"))}
    bundle = build_model(cfg, dev)
    bundle.load_state_dict(sd)
    if bundle.from_features:
        bundle.vgg = build_vgg(cfg.replace(seed=int(fx["vgg_seed"]) - 1),
                               dev)[0]
    return bundle


def _masks_fixture(dev):
    """Phase 50: the masked stylize on the card against rpst's JAX
    (tests/fixtures/torch_port_masks.npz, 64px b2): the flagship yaml's
    multi_adain (attention se, use_mask; and with sort), ccam,
    sel_multi_adain, src, seg_adain and LD v1 with seeded label maps, f32
    (F32_TOL) and bf16 (MAE < 1e-2 or 3 x rpst's own bf16 distance); no B1
    and no B4 launched (rpst's gates: labels and use_mask keep the folded
    and int8 paths shut); the labels' filter read on the maps; then the SE
    flagship's train-mode loss parts (rtol 1e-4), float32 gradients (rtol
    5e-3, atol 1e-4 x max or 4 x the tensor's own float32 error in rpst)
    and moved BatchNorm statistics (1e-5)."""
    import numpy as np
    import torch
    from rpst_torch.bridge import from_flax_batch_stats, from_flax_params
    from rpst_torch.ops.segment import label_validity
    with np.load(MASKS_FIXTURE) as npz:
        fx = {k: npz[k] for k in npz.files}
    c, s, cl, sl = (torch.from_numpy(fx[k]).to(dev) for k in
                    ("content", "style", "c_labels", "s_labels"))
    valid = int(label_validity(cl, sl, 64).sum())
    if valid == 0:
        raise AssertionError("masks fixture: no label passes the filter")
    cases = sorted({k.split("/")[0] for k in fx if k.endswith("/config")})
    for case in cases:
        ref32 = fx[f"{case}/out_f32"]
        for dt in ("float32", "bfloat16"):
            bundle = _mask_case_bundle(dev, fx, case, dt)
            _reset_counts()
            out = bundle.stylize(c, s, cl, sl)
            torch.cuda.synchronize()
            launched = _counts(("B1", "B4"))
            if any(launched):
                raise AssertionError(f"{case} {dt} masked stylize launched "
                                     f"B1/B4 {launched}")
            if dt == "float32":
                err, mae = check_close(f"masks {case} f32", out,
                                       torch.from_numpy(ref32).to(dev), F32_TOL)
                note = f"max abs err {err:.3g}, MAE {mae:.3g} (tol {F32_TOL})"
            else:
                ref = fx[f"{case}/out_bf16"]
                got = out.float().cpu().numpy()
                mae = float(np.abs(got - ref).mean())
                own = float(np.abs(ref - ref32).mean())
                limit = max(MASK_BF16_MAE, MASK_BF16_OWN * own)
                if not (np.isfinite(got).all() and mae < limit):
                    raise AssertionError(f"masks {case} bf16 MAE {mae} >= "
                                         f"{limit} (rpst's own {own})")
                note = (f"MAE {mae:.3g} (limit {limit:.3g}; rpst's own bf16 "
                        f"distance {own:.3g})")
            log("50 masks fixture", f"{case} {dt}: {note}; B1/B4 0/0")
            del bundle
    bundle = _mask_case_bundle(dev, fx, "multi_adain", "float32")
    bundle.model.train()
    vgg = _5b_vgg(dev, int(fx["vgg_seed"]))
    _reset_counts()
    total, parts = bundle.loss(vgg, c, s)
    total.backward()
    if any(_counts(("B1", "B2", "B3", "B4", "B5"))):
        raise AssertionError("the SE flagship's loss launched a kernel")
    for k in ("content_loss", "style_loss", "total_loss"):
        got, want = float(parts[k].detach()), float(fx[f"multi_adain/{k}"])
        if not abs(got - want) <= LOSS_RTOL * abs(want):
            raise AssertionError(f"SE flagship {k}: {got} vs rpst {want}")
    ref = from_flax_params(_npz_tree(fx, "multi_adain/grads/"))
    f64 = from_flax_params(_npz_tree(fx, "multi_adain/grads_f64/"))
    worst = (0.0, "")
    for name, p in bundle.model.named_parameters():
        size = float(f64[name].abs().max())
        got = p.grad.detach().float().cpu()
        if size == 0.0:
            if float(got.abs().max()) > 1e-9:
                raise AssertionError(f"SE flagship {name}: a gradient where "
                                     "rpst's is zero")
            continue
        own = float((ref[name] - f64[name]).abs().max()) / size
        atol = max(GRAD_ATOL_REL, MASK_GRAD_SPREAD * own) * size
        err = (got - ref[name]).abs()
        if not bool((err <= atol + GRAD_RTOL * ref[name].abs()).all()):
            raise AssertionError(f"SE flagship gradient {name}: max abs err "
                                 f"{float(err.max())} > atol {atol}")
        worst = max(worst, (float(err.max()) / size, name))
    moved = from_flax_batch_stats(_npz_tree(fx, "multi_adain/stats_after/"))
    sd = bundle.model.state_dict()
    stat_err = max(float((sd[n].float().cpu() - v).abs().max())
                   for n, v in moved.items())
    if not stat_err <= 1e-5:
        raise AssertionError(f"SE flagship running statistics {stat_err}")
    log("50 masks fixture", f"{len(cases)} cases x f32/bf16 held; {valid} "
        "labels of the fixture's maps pass the filter; SE flagship train "
        f"mode: loss parts within {LOSS_RTOL}, gradients worst err / max "
        f"{worst[0]:.3g} ({worst[1]}), moved statistics {stat_err:.3g}")


def _photoreal(root, n=2, size=IMG):
    """The synthetic photoreal test set (tools/make_photoreal_set.py)."""
    return _tool("make_photoreal_set").make_photoreal_set(root, n, size)


def _driver_run(script, args, timeout=600):
    """A driver as a subprocess; returns its log (stdout + stderr)."""
    proc = subprocess.run([sys.executable, str(REPO / script), *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=str(REPO))
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"{script} rc {proc.returncode}:\n{text[-3000:]}")
    return text


def _dump_names(path):
    return sorted(p.name for p in Path(path).iterdir())


def _flagship_yaml(dev):
    """Phase 51: configs/train_constant_multiscale_rp_adain.yaml as
    written (attention se, use_mask, photoreal test set, 512px b8 bf16)
    through train_torch.py as a subprocess, overriding only the data paths,
    the VGG (seeded: none is in the repository), the output and the
    cadence (max_iter 4, test_iter 2, log_iter 1, snapshot_save_iter 2):
    3 steps, a test dump at step 2 of the synthetic photoreal set (2 pairs)
    in which a masked AdaIN ran (the logged labels past the filter), no
    kernel launched; then test_torch.py on the saved checkpoint writes the
    same file names; the dumped PNG is the masked stylize of that
    checkpoint in this process (within 3 8-bit levels: bfloat16 on another
    process's cuDNN choices), and the unmasked one is further from it."""
    import numpy as np
    import torch
    from PIL import Image
    from rpst_torch.config import load_config
    from rpst_torch.data import build_test_dataset, iter_batches
    from rpst_torch.models import build_model
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "8", "--size", str(IMG)],
                       check=True, capture_output=True, timeout=300)
        photo = _photoreal(tmp / "photo")
        out = tmp / "flagship"
        paths = [f"content_dir={tmp / 'corpus' / 'content'}",
                 f"style_dir={tmp / 'corpus' / 'style'}",
                 f"test_dir={photo}", "vgg=", f"output={out}"]
        t0 = time.perf_counter()
        text = _driver_run("train_torch.py", [
            "--config", str(FLAGSHIP_YAML), "--device", "cuda", "--set",
            *paths, "max_iter=4", "test_iter=2", "log_iter=1",
            "snapshot_save_iter=2"])
        wall = time.perf_counter() - t0
        lines = [json.loads(ln) for ln in
                 (out / "logs" / "metrics.jsonl").read_text().splitlines()]
        if [ln["step"] for ln in lines] != [1, 2, 3] or any(
                ln["skipped"] or not np.isfinite(ln["total_loss"])
                for ln in lines):
            raise AssertionError(f"flagship yaml metrics: {lines}")
        valid = [int(m.split("masked AdaIN, ")[1].split(" ")[0])
                 for m in text.splitlines() if "masked AdaIN, " in m]
        names = [f"in{k}-tar{k}{t}" for k in range(2)
                 for t in ("-cat.png", ".png")]
        if _dump_names(out / "test" / "2") != sorted(names) \
                or not valid or not all(valid):
            raise AssertionError(f"flagship yaml test dump: "
                                 f"{_dump_names(out / 'test')} valid {valid}"
                                 f"\n{text[-3000:]}")
        if "B1/B2/B3 launches: 0/0/0" not in text:
            raise AssertionError("the SE flagship (standard) launched B1-B3")
        rate = [m for m in text.splitlines() if "Iterations 3," in m]
        log("51 flagship yaml", f"train_torch.py {FLAGSHIP_YAML.name} as "
            f"written ({IMG}px b8 bfloat16, attention se, use_mask): 3 steps "
            f"in {wall:.1f}s wall, total_loss "
            f"{[round(ln['total_loss'], 4) for ln in lines]}; test dump at "
            f"step 2: {len(names)} files, masked AdaIN with {valid} label(s) "
            f"past the filter; {rate[-1].split(' - ')[-1][:60] if rate else ''}")
        text = _driver_run("test_torch.py", [
            "--config", str(FLAGSHIP_YAML), "--device", "cuda", "--set",
            *paths])
        test_out = out / "test" / "test_output"
        if _dump_names(test_out) != sorted(names) \
                or "Loaded checkpoint" not in text:
            raise AssertionError(f"test_torch.py: {_dump_names(test_out)}"
                                 f"\n{text[-3000:]}")
        cfg = load_config(str(FLAGSHIP_YAML), dict(test_dir=str(photo),
                                                   vgg=""))
        bundle = build_model(cfg, dev)
        saved = torch.load(out / "checkpoints" / "3" / "state.pt",
                           map_location="cpu", weights_only=True)
        bundle.load_state_dict(saved["params"])
        content, style, c_names, s_names, c_m, s_m = next(iter_batches(
            build_test_dataset(cfg), cfg.batch_size))
        c, s = (torch.from_numpy(a).to(dev) for a in (content, style))
        cl, sl = (torch.from_numpy(a).to(dev) for a in (c_m, s_m))
        masked = bundle.stylize(c, s, cl, sl).cpu().numpy()
        plain = bundle.stylize(c, s).cpu().numpy()
        written = np.stack([np.asarray(Image.open(
            test_out / f"{cn}-{sn}.png"), np.float32)
            for cn, sn in zip(c_names, s_names)])
        to8 = lambda a: np.floor(np.clip(a, 0, 1) * 255 + 0.5)  # noqa: E731
        gap_masked = float(np.abs(to8(masked) - written).max())
        gap_plain = float(np.abs(to8(plain) - written).max())
        if not (gap_masked <= 3.0 and gap_plain > gap_masked + 2.0):
            raise AssertionError(f"test_torch.py's PNGs: {gap_masked} levels "
                                 f"from the masked stylize, {gap_plain} from "
                                 "the unmasked one")
        log("51 flagship yaml", f"test_torch.py on checkpoint 3: the same "
            f"{len(names)} files; its PNGs within {gap_masked:.0f} level of "
            f"the masked stylize, {gap_plain:.0f} levels from the unmasked")


def _masks_timing(dev, rng, name_power):
    """Phase 52: the flagship yaml's model (attention se, use_mask; seeded
    weights) at 512px b1 / b8, bf16 and f32: the masked stylize (the
    photoreal label maps of tools/make_photoreal_set.py) against the same
    model without labels, in both orders (masked, plain, plain, masked),
    CUDA events, median of 3 after 1, the peak device memory of each; the
    masked AdaIN op alone at (8, 512, 512, 32) against the plain AdaIN; the
    yaml's b8 bf16 train step, img/s and peak memory."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.ops.segment import masked_adain_batch
    from rpst_torch.ops.stats import adaptive_instance_normalization
    from rpst_torch.train.step import create_train_state, train_step
    label_maps = _tool("make_photoreal_set").label_maps
    rows = {}
    for batch in (1, 8):
        c, s = (torch.from_numpy(rng.random((batch, IMG, IMG, 3),
                                            np.float32)).to(dev)
                for _ in range(2))
        maps = [label_maps(IMG, rng) for _ in range(batch)]
        cl, sl = (torch.from_numpy(np.stack([m[i] for m in maps])
                                   .astype(np.int64)).to(dev) for i in (0, 1))
        for dt in ("bfloat16", "float32"):
            cfg = load_config(str(FLAGSHIP_YAML), dict(vgg="",
                                                       compute_dtype=dt))
            bundle = build_model(cfg, dev)
            init_torch_default(bundle.model, 0)
            paths = {"masked": lambda: bundle.stylize(c, s, cl, sl),
                     "plain": lambda: bundle.stylize(c, s)}
            for path in ("masked", "plain", "plain", "masked"):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                ms = cuda_ms(paths[path], iters=3, warmup=1)
                peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
                rows.setdefault((batch, dt, path), []).append(ms)
                log("52 masks timing", f"{IMG}px b{batch} {dt:8s} {path:6s}: "
                    f"{ms:9.3f} ms {batch * 1e3 / ms:8.2f} img/s, peak "
                    f"{peak:.2f} GiB ({name_power})")
            del bundle
        del c, s, cl, sl
    feat = torch.randn(8, IMG, IMG, 32, device=dev)
    sfeat = torch.randn(8, IMG, IMG, 32, device=dev) * 2 + 1
    maps = [label_maps(IMG, rng) for _ in range(8)]
    cl, sl = (torch.from_numpy(np.stack([m[i] for m in maps])
                               .astype(np.int64)).to(dev) for i in (0, 1))
    op_ms = cuda_ms(lambda: masked_adain_batch(feat, sfeat, cl, sl, 64),
                    iters=5, warmup=2)
    plain_ms = cuda_ms(lambda: adaptive_instance_normalization(feat, sfeat),
                       iters=5, warmup=2)
    log("52 masks timing", f"masked AdaIN (8, {IMG}, {IMG}, 32) f32, 64 "
        f"labels: {op_ms:.3f} ms; plain AdaIN {plain_ms:.3f} ms "
        f"({name_power})")
    del feat, sfeat
    cfg = load_config(str(FLAGSHIP_YAML), dict(vgg=""))
    bundle = build_model(cfg, dev)
    init_torch_default(bundle.model, 0)
    vgg = _5b_vgg(dev, 1)
    c, s = (torch.from_numpy(rng.random((cfg.batch_size, IMG, IMG, 3),
                                        np.float32)).to(dev)
            for _ in range(2))
    state = create_train_state(bundle)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    ms = cuda_ms(lambda: train_step(state, vgg, c, s), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if any(_counts(("B1", "B2", "B3", "B5"))):
        raise AssertionError("the SE flagship's train step launched a kernel")
    log("52 masks timing", f"train step {FLAGSHIP_YAML.name} {IMG}px "
        f"b{cfg.batch_size} {cfg.compute_dtype} (attention se): {ms:9.3f} "
        f"ms/step {cfg.batch_size * 1e3 / ms:8.2f} img/s, peak {peak:.2f} "
        f"GiB ({name_power})")
    del state, bundle
    torch.cuda.empty_cache()


def _test_torch_paths(dev):
    """Phase 53: test_torch.py beyond masks, as subprocesses: on the recon
    yaml (iden_photoreal, unmasked) with exec_strategy folded at 512px, its
    2 pairs one batch of 2: one folded stylize, 15 B1 launches (logged by
    test_torch.py); on configs/train_dynamic_sanet.yaml (paired set, b1):
    the stylized PNGs and dynamic_sanet's claim-map sheets, one a batch
    (the PIL route where matplotlib is missing). Returns the recon run's
    B1 launches."""
    from PIL import Image
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        photo = _photoreal(tmp / "photo")
        out = tmp / "recon"
        text = _driver_run("test_torch.py", [
            "--config", str(RECON_YAML), "--device", "cuda", "--set",
            "exec_strategy=folded", f"test_dir={photo}", "vgg=",
            f"output={out}"])
        b1 = _logged_count(text, "B1")
        files = _dump_names(out / "test" / "test_output")
        if b1 != B1_PER_STYLIZE or len(files) != 4:
            raise AssertionError(f"recon test_torch.py: {b1} B1, {files}\n"
                                 f"{text[-3000:]}")
        log("53 test_torch", f"{RECON_YAML.name} (exec_strategy folded, "
            f"iden_photoreal, {IMG}px b2): {len(files)} files, {b1} B1 "
            "launches (one folded stylize)")
        paired = tmp / "paired"
        for sub, stem in (("content", "in"), ("style", "tar")):
            (paired / sub).mkdir(parents=True)
            for k in range(2):
                Image.open(photo / sub / f"{stem}{k}.png").save(
                    paired / sub / f"p{k}.png")
        out = tmp / "dyn"
        _driver_run("test_torch.py", [
            "--config", str(DYN_YAML), "--device", "cuda", "--set",
            f"test_dir={paired}", "vgg=", f"output={out}"])
        sheets = _dump_names(out / "claim_map")
        sizes = [Image.open(out / "claim_map" / n).size for n in sheets]
        files = _dump_names(out / "test" / "test_output")
        if sheets != ["it_0_bid_0.png", "it_0_bid_1.png"] or len(files) != 4:
            raise AssertionError(f"dynamic_sanet test_torch.py: {sheets}, "
                                 f"{files}")
        log("53 test_torch", f"{DYN_YAML.name} ({IMG}px b1, paired): "
            f"{len(files)} files and claim maps {sheets} {sizes}")
    return b1



# ---- 54-56. slice 4's remainder, grad_accum and remat ----------------------
S4R_FIXTURE = REPO / "tests" / "fixtures" / "torch_port_slice4r.npz"
DEEPER_YAML = REPO / "configs" / "train_deeper_multiscale_rp_adain.yaml"
# the bf16 rule of phase 50 (MAE < 1e-2 or 3 x rpst's own bf16 distance);
# gradients by the slice-5b rule with the card's spread (4 x the larger of
# the two frameworks' own float32 errors), float64 at 1e-4 of max
S4R_SPREAD_CARD = 4.0
# a gradient under this share of the largest of its model is zero but for
# rounding (a conv bias before a batch / instance norm or an AdaIN); the
# port's is then held under ten times that
S4R_ZERO = 1e-5
# the folded flagship train step's launches per microbatch (PER_STEP), and
# with remat: the whole loss recomputed in the backward runs every B1 of
# the forward again (the 4 of the no-grad VGG target pass too: the
# non-reentrant checkpoint reruns the function up to its last saved
# tensor, the loss), B2 and B3 unchanged
def remat_per_step(accum, remat):
    b1, b2, b3 = PER_STEP
    return (b1 * accum * (2 if remat else 1), b2 * accum, b3 * accum)


def _s4r_port_name(path):
    """A flax param path of the slice-4r fixture -> the port's name."""
    *stem, leaf = path.split("/")
    if leaf == "kernel" or (leaf == "scale" and stem
                            and stem[-1].startswith(("bn", "BatchNorm_"))):
        leaf = "weight"
    return ".".join([*stem, leaf])


def _s4r_grad_view(grad, kind):
    """The port's gradient in the fixture's layout: a kernel's HWIO [...,
    :8, :8] corner, a Linear weight as flax's (in, out) corner."""
    if kind == "grads":
        return grad
    g = grad.permute(2, 3, 1, 0) if grad.dim() == 4 else grad.t()
    return g[..., :8, :8]


def s4r_check_grads(label, fx, case, g32, g64, spread):
    """The port's float32 (``g32``) and float64 (``g64``) gradients of a
    slice-4r case (name -> tensor) against rpst's (the fixture's
    ``<case>/grads|gradpatch|gradnorm`` and ``<case>/f64/...``): float64
    within 1e-4 of max (+ 5e-3 x |value|); float32 within 1e-4 of max or
    ``spread`` x the larger of the two frameworks' own float32 errors where
    that is more (+ 5e-3 x |value|), the port's own error under 3e-3 or
    twice rpst's worst; a rounding-zero tensor (S4R_ZERO) stays one.
    Returns (worst float32 err / max, worst float64 err / max, zeros)."""
    import numpy as np
    pre = f"{case}/"
    keys = [k for k in fx if k.startswith(pre) and k.split("/")[1] in
            ("grads", "gradpatch")]
    top = max(float(np.abs(fx[f"{pre}f64/{k[len(pre):]}"]).max())
              for k in keys)
    views = {}
    for key in keys:
        kind, _, path = key[len(pre):].partition("/")
        name = _s4r_port_name(path)
        views[key] = tuple(_s4r_grad_view(g[name], kind).double().cpu()
                           .numpy() for g in (g32, g64))
    live = [k for k in keys
            if float(np.abs(fx[f"{pre}f64/{k[len(pre):]}"]).max())
            >= S4R_ZERO * top]
    rpst_worst = max(float(np.abs(fx[k] - fx[f"{pre}f64/{k[len(pre):]}"])
                           .max()) / float(np.abs(fx[
                               f"{pre}f64/{k[len(pre):]}"]).max())
                     for k in live)
    w32 = w64 = 0.0
    zeros = 0
    for key in keys:
        ref, ref64 = fx[key], fx[f"{pre}f64/{key[len(pre):]}"]
        got, got64 = views[key]
        if key not in live:
            if float(np.abs(got).max()) > 10 * S4R_ZERO * top:
                raise AssertionError(f"{label} {key}: {np.abs(got).max()} "
                                     "where rpst's gradient is zero")
            zeros += 1
            continue
        size = float(np.abs(ref64).max())
        e64 = np.abs(got64 - ref64)
        if not (e64 <= GRAD_ATOL_REL * size + GRAD_RTOL * np.abs(ref64)).all():
            raise AssertionError(f"{label} {key} float64: max err "
                                 f"{e64.max() / size:.3g} x max")
        own_port = float(np.abs(got - got64).max()) / size
        own_rpst = float(np.abs(ref - ref64).max()) / size
        if own_port > max(3e-3, 2 * rpst_worst):
            raise AssertionError(f"{label} {key}: the port's own float32 "
                                 f"error {own_port:.3g}, rpst's worst "
                                 f"{rpst_worst:.3g}")
        atol = max(GRAD_ATOL_REL, spread * max(own_port, own_rpst)) * size
        e32 = np.abs(got - ref)
        if not (e32 <= atol + GRAD_RTOL * np.abs(ref)).all():
            raise AssertionError(f"{label} {key} float32: max err "
                                 f"{e32.max() / size:.3g} x max (atol "
                                 f"{atol / size:.3g})")
        w32 = max(w32, float(e32.max()) / size)
        w64 = max(w64, float(e64.max()) / size)
    return w32, w64, zeros


def s4r_case(dev, fx, case, spread, dtype="float32"):
    """One model case of tests/fixtures/torch_port_slice4r.npz on ``dev``
    (the card in phase 54, the CPU in tests/test_torch_slice4r.py): the
    stylize in ``dtype`` (f32 within F32_TOL or by the float64 rule with
    ``spread``, bf16 by phase 50's rule;
    masked with the fixture's label maps where the case sets use_mask),
    then in float32 the first train step (``train.step.train_step``, the
    case's grad_accum) in float32 and float64: its loss parts (rtol 1e-4),
    its gradients before Adam (``s4r_check_grads``) and the running
    statistics after it (1e-5). Returns a summary line."""
    import numpy as np
    import torch
    from rpst_torch import bridge
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.train.step import create_train_state, train_step
    raw = json.loads(str(fx[f"{case}/config"]))
    size = fx["content"].shape[1]
    c, s, cl, sl = (torch.from_numpy(fx[k]).to(dev) for k in
                    ("content", "style", "c_labels", "s_labels"))
    labels = (cl, sl) if raw.get("use_mask") else ()

    def bundle(dt, vgg=""):
        b = build_model(load_config(dict(raw, img_size=size, vgg=vgg,
                                         compute_dtype=dt)), dev)
        params, stats = bridge.flax_weights_from_seed(
            build_model(load_config(dict(raw, img_size=size))).model,
            int(fx["weights_seed"]))
        b.load_state_dict({**bridge.from_flax_params(params),
                           **bridge.from_flax_batch_stats(stats)})
        return b

    b = bundle(dtype)
    if b.folded_infer() or b.q8_infer():
        raise AssertionError(f"{case}: the folded / q8 gate is open")
    out = b.stylize(c, s, *labels)
    ref32 = torch.from_numpy(fx[f"{case}/out_f32"]).to(dev)
    if dtype == "float32":
        # F32_TOL, or where float32 itself errs more (the seeded deeper
        # stack's outputs reach ~270), ``spread`` x the larger of the two
        # frameworks' own distances from rpst's float64 stylize (its
        # masked AdaIN and statistics in float64 too); the port's own
        # distance under ``spread`` x rpst's
        got = out.double().cpu().numpy()
        ref = fx[f"{case}/out_f32"].astype(np.float64)
        ref64 = fx[f"{case}/out_f64"]
        own_port = float(np.abs(got - ref64).max())
        own_rpst = float(np.abs(ref - ref64).max())
        atol = max(F32_TOL, spread * max(own_port, own_rpst))
        err = np.abs(got - ref)
        if not (np.isfinite(got).all() and own_port <= max(
                F32_TOL, spread * own_rpst)
                and (err <= atol + F32_TOL * np.abs(ref)).all()):
            raise AssertionError(f"slice4r {case} f32: max abs err "
                                 f"{err.max()} (atol {atol}); own float32 "
                                 f"errors: port {own_port}, rpst {own_rpst}")
        note = (f"stylize f32 max abs err {err.max():.3g} (own float32 "
                f"errors vs float64: port {own_port:.3g}, rpst "
                f"{own_rpst:.3g}; max |out| {np.abs(ref64).max():.3g})")
    else:
        ref = fx[f"{case}/out_bf16"]
        got = out.float().cpu().numpy()
        mae = float(np.abs(got - ref).mean())
        own = float(np.abs(ref - fx[f"{case}/out_f32"]).mean())
        limit = max(MASK_BF16_MAE, MASK_BF16_OWN * own)
        if not (np.isfinite(got).all() and mae < limit):
            raise AssertionError(f"slice4r {case} bf16 MAE {mae} >= {limit}")
        return f"{case} bf16 stylize MAE {mae:.3g} (limit {limit:.3g})"
    del b
    grads, parts = {}, {}
    stat_err = 0.0
    for dt in (torch.float32, torch.float64):
        b = bundle("float32")
        b.model.to(dt)
        vgg = _5b_vgg(dev, int(fx["vgg_seed"])).to(dt)
        state = create_train_state(b)
        first = {}

        def keep(optimizer, args, kwargs, model=b.model, first=first):
            first.update({n: p.grad.detach().clone()
                          for n, p in model.named_parameters()})
        hook = state.optimizer.register_step_pre_hook(keep)
        parts[dt] = train_step(state, vgg, c.to(dt), s.to(dt))
        hook.remove()
        grads[dt] = first
        if dt == torch.float32:
            moved = bridge.from_flax_batch_stats(_npz_tree(
                fx, f"{case}/stats_after/"))
            sd = b.model.state_dict()
            stat_err = max([float((sd[n].float().cpu() - v).abs().max())
                            for n, v in moved.items()] or [0.0])
            if set(moved) != {n for n, _ in b.model.named_buffers()} \
                    or not stat_err <= 1e-5:
                raise AssertionError(f"slice4r {case} running statistics "
                                     f"{stat_err}")
        del b, state
    for k in ("content_loss", "style_loss", "total_loss"):
        got, want = float(parts[torch.float32][k]), float(fx[f"{case}/{k}"])
        if not abs(got - want) <= LOSS_RTOL * abs(want):
            raise AssertionError(f"slice4r {case} {k}: {got} vs rpst {want}")
    w32, w64, zeros = s4r_check_grads(f"slice4r {case}", fx, case,
                                      grads[torch.float32],
                                      grads[torch.float64], spread)
    return (f"{case}: {note}; step (grad_accum {raw.get('grad_accum', 1)}) "
            f"loss parts within {LOSS_RTOL}, gradients worst err / max "
            f"{w32:.3g} (float32), {w64:.3g} (float64), {zeros} zero up to "
            f"rounding; running statistics {stat_err:.3g}")


def s4r_block(dev, fx, case):
    """A Conv2dBlock case of the slice-4r fixture (bn / in, prelu,
    inception, SK): eval and train outputs within F32_TOL, the running
    statistics after the train forward within 1e-5."""
    import torch
    from rpst_torch import bridge
    from rpst_torch.nn.blocks import Conv2dBlock
    raw = json.loads(str(fx[f"{case}/config"]))
    cin, feat = raw.pop("in_features"), raw.pop("features")
    block = Conv2dBlock(cin, feat, **raw)
    params, stats = bridge.flax_weights_from_seed(block,
                                                  int(fx["weights_seed"]))
    block.load_state_dict({**bridge.from_flax_params(params),
                           **bridge.from_flax_batch_stats(stats)})
    block.to(dev)
    x = torch.from_numpy(fx[f"{case}/x"]).to(dev).permute(0, 3, 1, 2)
    errs = []
    with torch.no_grad():
        for mode in ("eval", "train"):
            block.train(mode == "train")
            out = block(x).permute(0, 2, 3, 1)
            errs.append(check_close(
                f"slice4r {case} {mode}", out,
                torch.from_numpy(fx[f"{case}/out_{mode}"]).to(dev),
                F32_TOL)[0])
    moved = bridge.from_flax_batch_stats(_npz_tree(fx, f"{case}/stats_after/"))
    sd = block.state_dict()
    stat_err = max([float((sd[n].cpu() - v).abs().max())
                    for n, v in moved.items()] or [0.0])
    if not stat_err <= 1e-5:
        raise AssertionError(f"slice4r {case} running statistics {stat_err}")
    return (f"{case} ({raw}): eval / train max abs err {errs[0]:.3g} / "
            f"{errs[1]:.3g}, running statistics {stat_err:.3g}")


def _s4r_fixture(dev):
    """Phase 54: slice 4's remainder on the card against rpst's JAX
    (tests/fixtures/torch_port_slice4r.npz, 64px b2, weights drawn by
    bridge.flax_weights_from_seed): the deeper yaml's model (deeper
    stacks, 3 inception convs a block, hidden 16, use_mask with seeded
    label maps: masked stylize), a constant multi_adain with SK attention
    at full width, the SE flagship yaml's model under grad_accum 2 (rpst's
    _accumulate_grads: loss parts, gradients, BatchNorm statistics moved
    twice), each in f32 and bf16, with float32 and float64 gradients by
    the slice-5b rule; the Conv2dBlocks with bn / in and prelu (and
    inception, SK); no B1 and no B4 launched (rpst's gates stay shut)."""
    import numpy as np
    with np.load(S4R_FIXTURE) as npz:
        fx = {k: npz[k] for k in npz.files}
    cases = sorted({k.split("/")[0] for k in fx if k.endswith("/config")})
    for case in cases:
        _reset_counts()
        if f"{case}/x" in fx:
            log("54 slice4r fixture", s4r_block(dev, fx, case))
        else:
            for dt in ("float32", "bfloat16"):
                log("54 slice4r fixture",
                    s4r_case(dev, fx, case, S4R_SPREAD_CARD, dt))
        if any(_counts(("B1", "B4"))):
            raise AssertionError(f"slice4r {case} launched B1/B4 "
                                 f"{_counts(('B1', 'B4'))}")


def _deeper_yaml(dev, name_power):
    """Phase 55: configs/train_deeper_multiscale_rp_adain.yaml as written
    (512px b1 float32, deeper stacks, 3 inception convs a block, hidden
    16, use_mask, photoreal test set) through train_torch.py as a
    subprocess, only the data paths, the VGG (seeded), the output and the
    cadence overridden: 3 steps and a test dump at step 2 in which a masked
    AdaIN ran (test_torch.py runs in phases 51 and 53); then the yaml's
    train step timed in float32 and in bfloat16 (CUDA events,
    median of 3 after 1) with its peak memory, no kernel launched."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.train.step import create_train_state, train_step
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "4", "--size", str(IMG)],
                       check=True, capture_output=True, timeout=300)
        photo = _photoreal(tmp / "photo")
        out = tmp / "deeper"
        paths = [f"content_dir={tmp / 'corpus' / 'content'}",
                 f"style_dir={tmp / 'corpus' / 'style'}",
                 f"test_dir={photo}", "vgg=", f"output={out}",
                 "num_workers=2"]
        t0 = time.perf_counter()
        text = _driver_run("train_torch.py", [
            "--config", str(DEEPER_YAML), "--device", "cuda", "--set",
            *paths, "max_iter=4", "test_iter=2", "log_iter=1",
            "snapshot_save_iter=2"])
        wall = time.perf_counter() - t0
        lines = [json.loads(ln) for ln in
                 (out / "logs" / "metrics.jsonl").read_text().splitlines()]
        if [ln["step"] for ln in lines] != [1, 2, 3] or any(
                ln["skipped"] or not np.isfinite(ln["total_loss"])
                for ln in lines):
            raise AssertionError(f"deeper yaml metrics: {lines}")
        valid = [int(m.split("masked AdaIN, ")[1].split(" ")[0])
                 for m in text.splitlines() if "masked AdaIN, " in m]
        names = [f"in{k}-tar{k}{t}" for k in range(2)
                 for t in ("-cat.png", ".png")]
        if _dump_names(out / "test" / "2") != sorted(names) \
                or not valid or not all(valid) \
                or "B1/B2/B3 launches: 0/0/0" not in text:
            raise AssertionError(f"deeper yaml test dump: "
                                 f"{_dump_names(out / 'test')} valid {valid}"
                                 f"\n{text[-3000:]}")
        log("55 deeper yaml", f"train_torch.py {DEEPER_YAML.name} as written "
            f"({IMG}px b1 float32, deeper, inception 3, use_mask): 3 steps "
            f"in {wall:.1f}s wall, total_loss "
            f"{[round(ln['total_loss'], 4) for ln in lines]}; test dump at "
            f"step 2: {len(names)} files, masked AdaIN with {valid} label(s) "
            "past the filter; B1/B2/B3 0/0/0")
    vgg = _5b_vgg(dev, 1)
    rng = np.random.default_rng(55)
    for dt in ("float32", "bfloat16"):
        cfg = load_config(str(DEEPER_YAML), dict(img_size=IMG, vgg="",
                                                 test_dir="",
                                                 compute_dtype=dt))
        b = build_model(cfg, dev)
        init_torch_default(b.model, 0)
        c, s = (torch.from_numpy(rng.random((cfg.batch_size, IMG, IMG, 3),
                                            np.float32)).to(dev)
                for _ in range(2))
        state = create_train_state(b)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        ms = cuda_ms(lambda: train_step(state, vgg, c, s), iters=3, warmup=1)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if any(_counts(("B1", "B2", "B3", "B4", "B5"))):
            raise AssertionError("the deeper yaml's step launched a kernel")
        log("55 deeper yaml", f"train step {DEEPER_YAML.name} {IMG}px "
            f"b{cfg.batch_size} {dt}: {ms:9.3f} ms/step "
            f"{cfg.batch_size * 1e3 / ms:8.2f} img/s, peak {peak:.2f} GiB "
            f"({name_power})")
        del state, b, c, s
        torch.cuda.empty_cache()


def _accum_remat(dev, name_power):
    """Phase 56: grad_accum and remat on the folded flagship train step
    (bench config, exec_strategy folded) at 512px b8, bf16 and f32:
    grad_accum 1 / 2 / 4 with remat off and on, each 1 + 2 timed steps
    with exact B1 / B2 / B3 launches (remat_per_step), its first step's
    loss and float32 gradients held to grad_accum 1's (no BatchNorm: the
    full batch's; 1e-4 of max + 5e-3 x |value|; with remat alone 1e-6 of
    max), step time and peak memory; the SE flagship yaml's model (64px
    b2, BatchNorm) in float64 with remat against the plain step: loss
    parts, gradients (1e-5 of max) and running statistics (moved once); spade's b4 float32 step at
    bench.py's widths (phase 43's, whose b4 f32 step outgrew 80 GB) with
    grad_accum 4: one step, its time and peak memory. Returns the B1 / B2 /
    B3 launches of the timed flagship steps."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    from rpst_torch.train.step import create_train_state, train_step
    rng = np.random.default_rng(56)
    vgg = _5b_vgg(dev, 1)
    c, s = (torch.from_numpy(rng.random((8, IMG, IMG, 3), np.float32))
            .to(dev) for _ in range(2))
    total = [0, 0, 0]

    def run(cfg, c, s, steps, timed, f64=False):
        """``steps`` train steps of a bundle of ``cfg`` (seeded by
        init_torch_default) or of ``cfg()``, a bundle factory; ``f64``:
        the model, VGG and images in float64."""
        if callable(cfg):
            b = cfg()
        else:
            b = build_model(cfg, dev)
            init_torch_default(b.model, 0)
        enc = vgg
        if f64:
            b.model.double()
            enc = copy.deepcopy(vgg).double()
            c, s = c.double(), s.double()
        state = create_train_state(b)
        first, losses = {}, []

        def keep(optimizer, args, kwargs):
            if not first:
                first.update({n: p.grad.detach().to(torch.promote_types(
                    p.grad.dtype, torch.float32)).clone()
                    for n, p in b.model.named_parameters()})
        hook = state.optimizer.register_step_pre_hook(keep)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        times = []
        for i in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            parts = train_step(state, enc, c, s)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            losses.append({k: float(v) for k, v in parts.items()})
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        hook.remove()
        counts = _counts()
        bufs = {n: x.detach().clone() for n, x in b.model.named_buffers()}
        del state, b
        torch.cuda.empty_cache()
        ms = statistics.median(times[1:]) if timed else times[-1]
        return ms, peak, counts, first, losses, bufs

    for dt in ("bfloat16", "float32"):
        base = None
        for accum in (1, 2, 4):
            for remat in (False, True):
                cfg = load_config(dict(FLAGSHIP, img_size=IMG, batch_size=8,
                                       exec_strategy="folded", vgg="",
                                       compute_dtype=dt, grad_accum=accum,
                                       remat=remat))
                ms, peak, counts, first, losses, _ = run(cfg, c, s, 3, True)
                want = tuple(3 * n for n in remat_per_step(accum, remat))
                if counts != want:
                    raise AssertionError(f"accum {accum} remat {remat} {dt}: "
                                         f"B1/B2/B3 {counts}, want {want}")
                total = [t + n for t, n in zip(total, counts)]
                note = ""
                if base is None:
                    base = (first, losses[0])
                elif dt == "float32":
                    tight = accum == 1  # remat alone: the same sums
                    worst = 0.0
                    for n, g in base[0].items():
                        size = float(g.abs().max())
                        atol = (1e-6 if tight else GRAD_ATOL_REL) * size
                        e = (first[n] - g).abs()
                        if not bool((e <= atol + (0 if tight else GRAD_RTOL)
                                     * g.abs()).all()):
                            raise AssertionError(
                                f"accum {accum} remat {remat}: gradient {n} "
                                f"max err {float(e.max()) / size:.3g} x max")
                        worst = max(worst, float(e.max()) / size)
                    for k, v in base[1].items():
                        if k != "skipped" and not abs(losses[0][k] - v) <= (
                                1e-6 if tight else 1e-5) * abs(v):
                            raise AssertionError(f"accum {accum} remat "
                                                 f"{remat} {k}: {losses[0][k]}"
                                                 f" vs {v}")
                    note = (f"; gradients vs grad_accum 1 worst err / max "
                            f"{worst:.3g}")
                log("56 accum/remat", f"folded flagship {IMG}px b8 {dt} "
                    f"grad_accum {accum} remat {str(remat).lower()}: "
                    f"{ms:9.3f} ms/step {8e3 / ms:7.2f} img/s, peak "
                    f"{peak:6.2f} GiB, B1/B2/B3 a step "
                    f"{'/'.join(str(n // 3) for n in counts)}{note} "
                    f"({name_power})")
    small = dict(network="multi_adain", rp_blocks=5, hidden_dim=32,
                 attention="se", img_size=64, batch_size=2, vgg="",
                 content_weight=1.0, style_weight=1.0)
    cs, ss = (torch.from_numpy(rng.random((2, 64, 64, 3), np.float32))
              .to(dev) for _ in range(2))
    # in float64: the float32 step moves by 7e-6 to 1.1e-5 of max between
    # two runs of itself on the card (the VGG max-pool backward's atomics),
    # the limit's size; float64 keeps that noise ~1e-15 (ROADMAP.md section C)
    plain = run(load_config(small), cs, ss, 1, False, f64=True)
    again = run(load_config(small), cs, ss, 1, False, f64=True)
    rem = run(load_config(dict(small, remat=True)), cs, ss, 1, False,
              f64=True)
    spread = max(float((again[3][n] - g).abs().max())
                 / max(float(g.abs().max()), 1e-30)
                 for n, g in plain[3].items())
    worst = 0.0
    for n, g in plain[3].items():
        size = float(g.abs().max())
        e = float((rem[3][n] - g).abs().max())
        if not e <= 1e-5 * size:
            raise AssertionError(f"SE remat gradient {n}: {e / size:.3g} x "
                                 f"max")
        worst = max(worst, e / size)
    stat = max(float((rem[5][n] - v).abs().max()) for n, v in plain[5].items())
    loss = abs(rem[4][0]["total_loss"] - plain[4][0]["total_loss"])
    if not (stat <= 1e-6 and loss <= 1e-6 * abs(plain[4][0]["total_loss"])):
        raise AssertionError(f"SE remat vs plain: statistics {stat}, loss "
                             f"{loss}")
    log("56 accum/remat", f"SE flagship (BatchNorm) 64px b2 float64 remat vs "
        f"plain: total_loss off by {loss:.3g}, gradients worst {worst:.3g} x "
        f"max (limit 1e-5; plain vs plain {spread:.3g}), running statistics "
        f"{stat:.3g} (moved once)")
    cs, ss = (torch.from_numpy(rng.random((4, IMG, IMG, 3), np.float32))
              .to(dev) for _ in range(2))
    ms, peak, counts, _, losses, _ = run(
        lambda: _5b_bundle(dev, "spade", IMG, grad_accum=4), cs, ss, 1,
        False)
    if not np.isfinite(losses[0]["total_loss"]):
        raise AssertionError(f"spade b4 f32 grad_accum 4: {losses}")
    log("56 accum/remat", f"spade (bench.py's widths, phase 43's: rp_blocks "
        f"5, hidden 32, ndf 2) {IMG}px b4 float32 grad_accum 4: one step "
        f"{ms:9.3f} ms (the run's first, cuDNN's choices included), peak "
        f"{peak:6.2f} GiB, total_loss {losses[0]['total_loss']:.4f} "
        f"({name_power})")
    return tuple(total)


# ---------------------------------------------------------------- 57-59
# the lane-filling training shape of one row shard of a 512px image on
# {spatial: 2}: (1, 128, 256, 128 -> 128) folded; the only shape that reaches
# the halo kernels under rpst's gate (4C and 4Co multiples of 128)
HALO_SHAPE = (1, 128, 256, 128, 128)
SPATIAL_NETS = ("multi_adain", "sel_multi_adain", "ccam")
# phase 58's train steps on a mesh, (key, network, axis, px, global batch,
# grad_accum): the flagship on {data: 2} (the data-parallel gradient average)
# and sel_multi_adain there (BatchNorm over the global batch), both with
# rpst's global microbatches (``redeal_microbatches``); sel_multi_adain's and
# ccam's row-sharded steps with BatchNorm running statistics on {spatial: 2}
MESH_STEPS_58 = (("d2", "multi_adain", "data", IMG, 4, 2),
                 ("d2_sel", "sel_multi_adain", "data", 256, 4, 2),
                 ("s2_sel", "sel_multi_adain", "spatial", 256, 2, 1),
                 ("s2_ccam", "ccam", "spatial", 256, 2, 1))
# the spatial fixture's points (tools/make_torch_port_fixture.py
# spatial_sources(): the flagship train fixture and the two slice-4 ones)
SPATIAL_SRC = {
    "multi_adain": ("torch_port_train.npz",
                    dict(FLAGSHIP, content_weight=1.0, style_weight=1.0)),
    "sel_multi_adain": ("torch_port_sel_multi_adain.npz",
                        dict(FLAGSHIP, network="sel_multi_adain",
                             content_weight=1.0, style_weight=2.0)),
    "ccam": ("torch_port_ccam.npz",
             dict(FLAGSHIP, network="ccam", stylized_layers=5,
                  shuffle=False, shuffle_layers=1, content_weight=1.0,
                  style_weight=2.0)),
}


def _halo_kernels(dev, name_power):
    """Phase 57: B2 with row_rings=False and B3 with given rings, and
    FoldedConvActHalo's backward, against their plain versions at
    HALO_SHAPE with a folded and a dense kernel, float32 (1e-4) and
    bfloat16 (2e-2); B3 bit-equal across two runs in both modes; each
    timed beside its one-device mode, its plain version and the library
    call (conv2d_input / conv2d_weight on the ring-padded folded tensor).
    Returns the kernels-line numbers (f32, folded: B3 listed)."""
    import torch
    from torch.nn.grad import conv2d_input, conv2d_weight
    from rpst_torch.ops.folded import fold_conv_kernel, folded_reflect_pad
    from rpst_torch.ops import folded_conv as fc
    g = torch.Generator().manual_seed(57)
    n, h, w, c4, c4o = HALO_SHAPE
    dk_atol = DK_ATOL_512 * (n * h * w / 512) ** 0.5
    out = {}
    for kname in ("folded", "dense"):
        kf = (fold_conv_kernel(torch.randn(3, 3, c4 // 4, c4o // 4,
                                           generator=g) * 0.2)
              if kname == "folded"
              else torch.randn(3, 3, c4, c4o, generator=g) * 0.05)
        x = torch.randn(n, h, w, c4, generator=g)
        gz = torch.randn(n, h, w, c4o, generator=g)
        rings = torch.randn(n, 2, w, c4, generator=g)
        b = torch.randn(c4o, generator=g) * 0.1
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            kind, size = ("f32", 4) if dt == torch.float32 else ("bf16", 2)
            xd, gd, rd, kd = (t.to(dev, dt).contiguous()
                              for t in (x, gz, rings, kf))
            khat = kd.flip(0, 1).transpose(2, 3).contiguous()
            dx = fc.fused_folded_conv_grad_input(gd, khat, row_rings=False)
            torch.cuda.synchronize()
            e2, _ = check_close(
                f"B2 halo {kname} {dt}", dx,
                fc.fused_folded_conv_grad_input_plain(gd, khat, False), tol)
            e3 = 0.0
            for listed in (True, False):
                dk, db = fc.fused_folded_conv_grad_weight(xd, gd, listed, rd)
                dk2, db2 = fc.fused_folded_conv_grad_weight(xd, gd, listed,
                                                            rd)
                torch.cuda.synchronize()
                if not (torch.equal(dk, dk2) and torch.equal(db, db2)):
                    raise AssertionError(f"B3 rings {kname} {dt} listed="
                                         f"{listed}: two runs differ")
                rdk, rdb = fc.fused_folded_conv_grad_weight_plain(
                    xd, gd, listed, rd)
                atol = dk_atol if dt == torch.float32 else BF16_TOL * max(
                    1.0, float(rdk.abs().max()))
                for name, a, r in (("dk", dk, rdk), ("db", db, rdb)):
                    err = float((a - r).abs().max())
                    if not torch.allclose(a, r, rtol=1e-4 if dt ==
                                          torch.float32 else BF16_TOL,
                                          atol=atol):
                        raise AssertionError(
                            f"B3 rings {kname} {dt} listed={listed} {name}:"
                            f" max abs err {err} (atol {atol:.3g})")
                    e3 = max(e3, err)
            # the Function's backward on the card vs autograd of B1's plain
            # version with the rings as inputs, on the same card tensors
            ins = [t.detach().requires_grad_(True) for t in
                   (xd, kd, b.to(dev, dt), rd[:, :1].contiguous(),
                    rd[:, 1:].contiguous())]
            y = fc.folded_conv_act_halo(*ins, listed=kname == "folded")
            got = torch.autograd.grad(y, ins, gd)
            ref_in = [t.detach().float().requires_grad_(True) for t in ins]
            y_ref = fc.fused_folded_conv_plain(
                *ref_in[:3], 0.2, rings=torch.cat(ref_in[3:], dim=1))
            ref = torch.autograd.grad(y_ref, ref_in, gd.float())
            ef = 0.0
            for name, a, r in zip(("dx", "dk", "db", "d_above", "d_below"),
                                  got, ref):
                if kname == "folded" and name == "dk":
                    # the listed mode: the fold's 36 blocks
                    mask = fc.listed_blocks().to(dev)[:, :, :, None, :, None]
                    r = (r.reshape(3, 3, 4, c4 // 4, 4, c4o // 4)
                         * mask).reshape(r.shape)
                sc = max(1.0, float(r.abs().max()))
                err = float((a.float() - r).abs().max())
                if not err <= (tol if name in ("dx", "d_above", "d_below")
                               else 4 * tol) * sc:
                    raise AssertionError(f"FoldedConvActHalo {kname} {dt} "
                                         f"{name}: max abs err {err}")
                ef = max(ef, err / sc)
            # timing beside the one-device modes
            xp = folded_reflect_pad(xd, rd).permute(0, 3, 1, 2)
            gp = gd.permute(0, 3, 1, 2)
            wf = kd.permute(3, 2, 0, 1).contiguous()
            listed = kname == "folded"
            t = {"B2": cuda_ms(lambda: fc.fused_folded_conv_grad_input(
                     gd, khat)),
                 "B2 halo": cuda_ms(lambda: fc.fused_folded_conv_grad_input(
                     gd, khat, row_rings=False)),
                 "B2 halo plain": cuda_ms(
                     lambda: fc.fused_folded_conv_grad_input_plain(
                         gd, khat, False)),
                 "B2 lib": cuda_ms(lambda: conv2d_input(xp.shape, wf, gp)),
                 "B3": cuda_ms(lambda: fc.fused_folded_conv_grad_weight(
                     xd, gd, listed)),
                 "B3 rings": cuda_ms(lambda: fc.fused_folded_conv_grad_weight(
                     xd, gd, listed, rd)),
                 "B3 rings plain": cuda_ms(
                     lambda: fc.fused_folded_conv_grad_weight_plain(
                         xd, gd, listed, rd)),
                 "B3 lib": cuda_ms(lambda: conv2d_weight(
                     xp, (c4o, c4, 3, 3), gp))}
            bnd = folded_bound(n, h, w, c4, c4o, kind, size, listed)
            log("57 halo", f"{HALO_SHAPE} {kind} {kname}: B2 row_rings=False "
                f"max abs err {e2:.3g}, B3 rings (listed + dense, bit-equal "
                f"across two runs) {e3:.3g}, FoldedConvActHalo backward "
                f"{ef:.3g} x max; B2 halo {t['B2 halo']:.4f} ms (one-device "
                f"mode {t['B2']:.4f}, plain {t['B2 halo plain']:.4f}, "
                f"conv2d_input {t['B2 lib']:.4f}); B3 rings {t['B3 rings']:.4f}"
                f" ms (reflect mode {t['B3']:.4f}, plain "
                f"{t['B3 rings plain']:.4f}, conv2d_weight {t['B3 lib']:.4f});"
                f" bound {bnd[0]:.4f} ms by {bnd[1]} ({name_power})")
            if (kind, kname) == ("f32", "folded"):
                out["B2"] = {"max_abs_err": e2, "ms": t["B2 halo"],
                             "plain_ms": t["B2 halo plain"],
                             "bound_ms": bnd[0], "bound_by": bnd[1],
                             "library_ms": t["B2 lib"]}
                out["B3"] = {"max_abs_err": e3, "ms": t["B3 rings"],
                             "plain_ms": t["B3 rings plain"],
                             "bound_ms": bnd[0], "bound_by": bnd[1],
                             "library_ms": t["B3 lib"]}
    return out


def _spatial_fixture_bundle(network, dev, dtype=None):
    """The port's bundle, VGG and images at the spatial fixture's point of
    ``network`` on ``dev`` (float64 on the CPU for ``dtype`` float64)."""
    import numpy as np
    import torch
    from rpst_torch.bridge import (flax_tree_from_npz, from_flax_batch_stats,
                                   from_flax_params, vgg_from_flax,
                                   vgg_weights_from_seed)
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.vgg import VGG19Encoder
    name, cfg = SPATIAL_SRC[network]
    with np.load(REPO / "tests" / "fixtures" / name) as npz:
        tree = flax_tree_from_npz(npz)
        fx = {k: npz[k] for k in ("content", "style", "vgg_seed")}
    bundle = build_model(load_config(dict(
        cfg, img_size=fx["content"].shape[1], exec_strategy="folded")), dev)
    sd = from_flax_params({k: v for k, v in tree.items()
                           if k in ("ms", "rp_shared_encoder", "rp_decoder",
                                    "attention_block")
                           or k.startswith("ccam_")})
    sd.update(from_flax_batch_stats(tree.get("batch_stats", {})))
    bundle.load_state_dict(sd)
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]))))
    vgg = vgg.to(dev)
    c, s = (torch.from_numpy(fx[k]).to(dev) for k in ("content", "style"))
    if dtype == torch.float64:
        bundle.model.double()
        bundle.folded_dtype = lambda: torch.float64
        vgg.double()
        c, s = c.double(), s.double()
    bundle.model.train()
    return bundle, vgg, c, s


def _corner(g):
    """The gradient corner the spatial fixture keeps (vectors whole, a
    kernel's or Linear's [:8, :8]) in the port's layout."""
    return g[:8, :8].contiguous() if g.ndim >= 2 else g


def _flagship_512(dev, network="multi_adain", size=IMG, n=2, **over):
    """A seeded full-width bundle of ``network`` at ``size`` px (512 by
    default; folded, f32, or as ``over`` says) and a batch of ``n``."""
    import numpy as np
    import torch
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model, build_vgg
    from rpst_torch.nn.blocks import init_torch_default
    cfg = load_config({**SPATIAL_SRC[network][1], "img_size": size,
                       "exec_strategy": "folded", "lr": 1e-4,
                       "lr_decay": 0.0, **over})
    bundle = build_model(cfg, dev)
    init_torch_default(bundle.model, 0)
    if network == "ccam":  # live CCAM residuals
        with torch.no_grad():
            for i, m in enumerate(bundle.model.channel_attentions):
                m.scale.fill_(0.3 + 0.1 * i)
    vgg, _ = build_vgg(cfg, dev)
    rng = np.random.default_rng(58)
    c, s = (torch.from_numpy(rng.random((n, size, size, 3), np.float32))
            .to(dev) for _ in range(2))
    bundle.model.train()
    return bundle, vgg, c, s


def _mesh_step(bundle, vgg, c, s, mesh):
    """One train_step on ``mesh`` (or one device): (total, the gradients
    the optimizer stepped on, the parameters before and after, buffers)."""
    from rpst_torch.train.step import create_train_state, train_step
    state = create_train_state(bundle, mesh=mesh)
    seen = {}

    def keep(opt, *_):
        seen.update({n: p.grad.detach().clone() for n, p in
                     bundle.model.named_parameters() if p.grad is not None})
    state.optimizer.register_step_pre_hook(keep)
    before = {n: p.detach().clone() for n, p in
              bundle.model.named_parameters()}
    parts = train_step(state, vgg, c, s)
    after = {n: p.detach().clone() for n, p in
             bundle.model.named_parameters()}
    buffers = {n: b.clone() for n, b in bundle.model.named_buffers()}
    return (float(parts["total_loss"]), seen, before, after, buffers,
            state.schedule(0))


def _run_mesh_steps(res, dev, s2, steps):
    """One rank's half of ``steps`` (``MESH_STEPS_58``' form) into ``res``:
    each step's loss, the gradients the optimizer stepped on, the
    parameters before and after, the buffers, and where grad_accum > 1 the
    time of ``redeal_microbatches`` on this rank's batch share; then the
    median of 3 re-deals (after one) of a 512px b8 global batch on {data:
    2} at grad_accum 2."""
    import torch
    from rpst_torch.dist import make_mesh, shard_batch
    from rpst_torch.train.step import redeal_microbatches
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    d2 = make_mesh({"data": 2}, dev)
    for key, net, axis, size, n, accum in steps:
        mesh = d2 if axis == "data" else s2
        bundle, vgg, c, s = _flagship_512(dev, net, size, n, grad_accum=accum)
        c_l, s_l = (shard_batch(t, mesh, spatial=axis == "spatial")
                    for t in (c, s))
        if accum > 1:
            sync()
            t0 = time.perf_counter()
            redeal_microbatches(c_l, mesh, accum)
            sync()
            res[f"{key}/redeal_s"] = torch.tensor(time.perf_counter() - t0)
        total, grads, before, after, buffers, lr = _mesh_step(
            bundle, vgg, c_l, s_l, mesh)
        res[f"{key}/total_loss"] = torch.tensor(total)
        res[f"{key}/lr"] = torch.tensor(lr)
        for n_, g in grads.items():
            res[f"{key}/grads/{n_}"] = g
            res[f"{key}/before/{n_}"] = before[n_]
            res[f"{key}/after/{n_}"] = after[n_]
        for n_, b in buffers.items():
            res[f"{key}/buffers/{n_}"] = b
        del bundle, vgg, c, s, c_l, s_l, grads, before, after, buffers
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    # the re-deal alone at a 512px b8 step's size (4 images a rank)
    x = torch.rand(4, IMG, IMG, 3, device=dev)
    times = []
    for _ in range(4):
        sync()
        t0 = time.perf_counter()
        redeal_microbatches(x, d2, 2)
        sync()
        times.append(time.perf_counter() - t0)
    res["redeal_b8_s"] = torch.tensor(statistics.median(times[1:]))


def spatial_rank(rank, init, out_dir):
    """Phase 58, one rank (``python3 chip_smoke.py --spatial-rank R INIT
    OUT``): joins the other rank over gloo on the one card and runs
    the row-sharded paths: the fixture's three networks at 64px on
    {spatial: 2} (stylize, loss, gradient corners); the flagship's 512px
    b2 stylize on {spatial: 2}; the ``MESH_STEPS_58`` train steps (the
    gradients the optimizer stepped on, the parameters before and after,
    the buffers; ``redeal_microbatches``' time where grad_accum > 1).
    Saves ``<out>/rank<r>.pt``: the results and this rank's launch
    counts."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO / "src"))
    from rpst_torch.dist import average_grads, make_mesh, shard_batch
    from rpst_torch.models.fast_path_spatial import (loss_spatial,
                                                     stylize_spatial)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)  # both ranks share the one card
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=2, rank=int(rank))
    res = {}
    try:
        s2 = make_mesh({"spatial": 2}, dev)
        _reset_counts()
        for net in SPATIAL_NETS:
            bundle, vgg, c, s = _spatial_fixture_bundle(net, dev)
            c_l, s_l = (shard_batch(t, s2, spatial=True) for t in (c, s))
            res[f"fx/{net}/out"] = stylize_spatial(bundle, c_l, s_l, s2)
            total, parts = loss_spatial(bundle, vgg, c_l, s_l, s2)
            total.backward()
            average_grads(list(bundle.model.parameters()), s2.reduce_axes())
            for k in ("content_loss", "style_loss", "total_loss"):
                res[f"fx/{net}/{k}"] = parts[k].detach()
            for n, p in bundle.model.named_parameters():
                res[f"fx/{net}/grads/{n}"] = _corner(p.grad)
        bundle, vgg, c, s = _flagship_512(dev)
        c_l, s_l = (shard_batch(t, s2, spatial=True) for t in (c, s))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res["512/out"] = stylize_spatial(bundle, c_l, s_l, s2)
        torch.cuda.synchronize()
        res["512/stylize_s"] = torch.tensor(time.perf_counter() - t0)
        _run_mesh_steps(res, dev, s2, MESH_STEPS_58)
        torch.cuda.synchronize()
        cnt = _counters()
        res["counts"] = torch.tensor([
            cnt["B1"].launches, cnt["B2"].launches, cnt["B3"].launches,
            cnt["B2"].launches_halo, cnt["B3"].launches_rings])
        dist.barrier()
    finally:
        torch.save({k: v.detach().cpu() for k, v in res.items()},
                   Path(out_dir) / f"rank{rank}.pt")
        dist.destroy_process_group()


def _check_grad_rule(label, got, ref, own, rel=4.0):
    """Each tensor of ``got`` within rtol 5e-3 and max(1e-4, rel x own)
    of the tensor's max from ``ref``; ``own`` the float32 errors per tensor
    (absolute). Returns the worst error / max."""
    import torch
    worst = 0.0
    for n, r in ref.items():
        a = got[n].double().cpu()
        r = r.double().cpu()
        size = max(float(r.abs().max()), 1e-30)
        err = float((a - r).abs().max())
        atol = max(1e-4, rel * own.get(n, 0.0) / size) * size
        if not torch.allclose(a, r, rtol=5e-3, atol=atol):
            raise AssertionError(f"{label} {n}: max abs err {err} "
                                 f"({err / size:.3g} x max, atol {atol:.3g})")
        worst = max(worst, err / size)
    return worst


def _check_mesh_steps(res, dev, steps):
    """Both ranks' ``_run_mesh_steps`` results (``res``) against the
    one-device steps (``_spatial_ranks`` states the rule); logs a line a
    step."""
    import numpy as np
    import torch
    for key, net, axis, size, n, accum in steps:
        b, v, c, s = _flagship_512(dev, net, size, n, grad_accum=accum)
        one = _mesh_step(b, v, c, s, None)
        loss = float(res[0][f"{key}/total_loss"])
        if not np.isclose(loss, one[0], rtol=LOSS_RTOL):
            raise AssertionError(f"58 {key} loss {loss} vs {one[0]}")
        got = {n_[len(f"{key}/grads/"):]: t for n_, t in res[0].items()
               if n_.startswith(f"{key}/grads/")}
        own = {}
        if net != "multi_adain":
            # the float32 noise of these gradients (the BatchNorm backward
            # and the CCAM softmax amplify it): the one-device folded step
            # against the one-device standard step (cuDNN), the same function
            b, v, c, s = _flagship_512(dev, net, size, n, grad_accum=accum,
                                       exec_strategy="standard")
            std = _mesh_step(b, v, c, s, None)[1]
            own = {n_: float((one[1][n_] - g).abs().max())
                   for n_, g in std.items() if n_ in one[1]}
        worst = _check_grad_rule(f"58 {key}", got, one[1], own)
        lr = float(res[0][f"{key}/lr"])
        adam = 0.0
        for n_, g in got.items():
            before = res[0][f"{key}/before/{n_}"]
            expect = before - lr * g / (g.abs() + 1e-8)
            for r in range(2):
                if not torch.equal(res[r][f"{key}/after/{n_}"],
                                   res[0][f"{key}/after/{n_}"]):
                    raise AssertionError(f"58 {key} {n_}: ranks differ")
            adam = max(adam, float((res[0][f"{key}/after/{n_}"]
                                    - expect).abs().max()))
        if not adam <= 1e-6:
            raise AssertionError(f"58 {key}: Adam step off by {adam}")
        stat = 0.0
        for n_, buf in one[4].items():
            for r in range(2):
                a = res[r][f"{key}/buffers/{n_}"]
                if not torch.allclose(a, buf.cpu(), rtol=1e-4, atol=1e-5):
                    raise AssertionError(f"58 {key} buffer {n_} rank {r}")
                stat = max(stat, float((a - buf.cpu()).abs().max()))
        redeal = ""
        if accum > 1:
            ms = float(res[0][f"{key}/redeal_s"]) * 1e3
            redeal = (f", redeal_microbatches {ms:.2f} ms on rank 0 "
                      f"({n // 2} images of {size}px a rank, gloo)")
        log("58 spatial", f"{net} {size}px b{n} grad_accum {accum} step on "
            f"{{{axis}: 2}}: loss {loss:.6g} (one device {one[0]:.6g}), "
            f"gradients worst {worst:.3g} x max, the Adam step the rule on "
            f"them (off by {adam:.3g}), ranks bit-equal, running statistics "
            f"within {stat:.3g}{redeal}")
        del b, v, c, s, one
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    log("58 spatial", f"redeal_microbatches of a {IMG}px b8 global batch on "
        f"{{data: 2}} at grad_accum 2 (4 images a rank, gloo): "
        f"{float(res[0]['redeal_b8_s']) * 1e3:.2f} ms on rank 0 (median of 3)")


def _spatial_ranks(dev, name_power):
    """Phase 58: two ranks on the one card over gloo (``spatial_rank``)
    against the one-device folded path on the card, and against rpst's
    row-sharded functions (tests/fixtures/torch_port_spatial.npz, {spatial:
    2}): stylize 1e-4; loss parts rtol 1e-4; float32 gradients within
    rtol 5e-3 and 4 x the larger own float32 error (rpst's: its float32
    against its float64; the port's: the card's against its one-device
    float64 on the CPU), at least 1e-4 of the max; the flagship's 512px
    stylize on {spatial: 2} against one device's, 1e-4; each
    ``MESH_STEPS_58`` step against the one-device step of the same global
    batch and grad_accum by phase 9's rule (loss rtol 1e-4; gradients rtol
    5e-3, 1e-4 of the max, or for sel_multi_adain and ccam 4 x their own
    float32 noise, the one-device folded step against the standard one),
    each rank's Adam step the optimizer's rule on those gradients, the two
    ranks bit-equal, the running statistics rtol 1e-4, atol 1e-5. Returns
    the launch counts of both ranks together."""
    import numpy as np
    import torch
    from rpst_torch.bridge import from_flax_params, from_flax_batch_stats
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--spatial-rank",
             str(r), str(tmp / "init"), str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=str(REPO))
            for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=400)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise AssertionError("phase 58 ranks failed:\n" + "\n".join(
                f"--- rank {r}\n{t[-3000:]}" for r, t in enumerate(logs)))
        res = [torch.load(tmp / f"rank{r}.pt", weights_only=True)
               for r in range(2)]
        wall = time.perf_counter() - t0
    fx_path = REPO / "tests" / "fixtures" / "torch_port_spatial.npz"
    with np.load(fx_path) as npz:
        fx = {k: npz[k] for k in npz.files}

    def fx_tree(net, what):
        prefix = f"{net}/s2/{what}/"
        tree = {}
        for k, v in fx.items():
            if k.startswith(prefix):
                node = tree
                *parents, leaf = k[len(prefix):].split("/")
                for q in parents:
                    node = node.setdefault(q, {})
                node[leaf] = v
        return (from_flax_batch_stats(tree) if what == "stats_after"
                else from_flax_params(tree))

    cat_rows = lambda key: torch.cat([res[0][key], res[1][key]],  # noqa
                                     dim=1)
    for net in SPATIAL_NETS:
        out = cat_rows(f"fx/{net}/out")
        err, _ = check_close(f"58 fixture {net} stylize", out,
                             torch.from_numpy(fx[f"{net}/s2/out"]), F32_TOL)
        for k in ("content_loss", "style_loss", "total_loss"):
            if not np.isclose(float(res[0][f"fx/{net}/{k}"]),
                              fx[f"{net}/s2/{k}"], rtol=LOSS_RTOL):
                raise AssertionError(f"58 fixture {net} {k}: "
                                     f"{float(res[0][f'fx/{net}/{k}'])} vs "
                                     f"{fx[f'{net}/s2/{k}']}")
        # the port's own float32 error: against its one-device float64 loss
        # on the CPU (the card's kernels take no float64)
        b64, vgg64, c64, s64 = _spatial_fixture_bundle(
            net, torch.device("cpu"), torch.float64)
        total64, _ = b64.loss(vgg64, c64, s64)
        total64.backward()
        g64 = {n: _corner(p.grad) for n, p in b64.model.named_parameters()}
        ref32, ref64 = fx_tree(net, "grads"), fx_tree(net, "grads_f64")
        got = {n[len(f"fx/{net}/grads/"):]: v for n, v in res[0].items()
               if n.startswith(f"fx/{net}/grads/")}
        own = {n: max(float((torch.as_tensor(ref32[n]).double()
                             - torch.as_tensor(ref64[n]).double()).abs().max()),
                      float((got[n].double() - g64[n]).abs().max()))
               for n in ref32}
        worst = _check_grad_rule(f"58 fixture {net}", got, ref32, own)
        log("58 spatial", f"{net} 64px b2 on {{spatial: 2}} vs rpst's "
            f"row-sharded functions: stylize max abs err {err:.3g}, loss "
            f"parts within rtol 1e-4, gradients worst {worst:.3g} x max")
    # 512px against the one-device folded path on the card
    bundle, vgg, c, s = _flagship_512(dev)
    with torch.inference_mode():
        ref_out = bundle.stylize(c, s)
    err, _ = check_close("58 512 stylize", cat_rows("512/out"), ref_out.cpu(),
                         F32_TOL)
    log("58 spatial", f"flagship {IMG}px b2 stylize on {{spatial: 2}} vs one "
        f"device: max abs err {err:.3g}")
    del bundle, vgg, c, s, ref_out
    _check_mesh_steps(res, dev, MESH_STEPS_58)
    counts = [int(x) for x in (res[0]["counts"] + res[1]["counts"])]
    log("58 spatial", f"two ranks over gloo on the one card: {wall:.1f}s "
        f"wall (shared card: no scaling figure); launches of both ranks "
        f"B1/B2/B3 {counts[0]}/{counts[1]}/{counts[2]}, of which B2 "
        f"row_rings=False {counts[3]}, B3 rings {counts[4]}; {IMG}px stylize "
        f"{float(res[0]['512/stylize_s']) * 1e3:.1f} ms on rank 0 "
        f"({name_power})")
    return counts


def _spatial_train_cli(dev):
    """Phase 59: train_torch.py with mesh_shape {spatial: 2} on the flagship
    yaml (the main path's model: attention none, use_mask false, folded),
    512px b8 bfloat16, 3 steps, its two ranks started by train_torch.py
    over gloo on the one card: one checkpoint tree, written by rank 0, its
    log lines only; returns rank 0's (B2 row_rings=False, B3 rings)
    launches."""
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "8", "--size", str(IMG)],
                       check=True, capture_output=True, timeout=300)
        out = tmp / "spatial"
        t0 = time.perf_counter()
        text = _driver_run("train_torch.py", [
            "--config", str(FLAGSHIP_YAML), "--device", "cuda", "--set",
            f"content_dir={tmp / 'corpus' / 'content'}",
            f"style_dir={tmp / 'corpus' / 'style'}", "test_dir=", "vgg=",
            f"output={out}", "attention=none", "use_mask=false",
            "exec_strategy=folded", "mesh_shape={spatial: 2}", "max_iter=4",
            "log_iter=1", "snapshot_save_iter=100", "num_workers=2"])
        wall = time.perf_counter() - t0
        lines = [json.loads(ln) for ln in
                 (out / "logs" / "metrics.jsonl").read_text().splitlines()]
        if [ln["step"] for ln in lines] != [1, 2, 3] or any(
                ln["skipped"] or not np.isfinite(ln["total_loss"])
                for ln in lines):
            raise AssertionError(f"59 spatial train metrics: {lines}")
        if _dump_names(out / "checkpoints") != ["3"]:
            raise AssertionError(f"59 checkpoints {_dump_names(out / 'checkpoints')}")
        iters = [m for m in text.splitlines() if "Iterations " in m]
        if len(iters) != 3 or "row-sharded folded training" not in text:
            raise AssertionError(f"59 log: {len(iters)} loss lines\n"
                                 f"{text[-3000:]}")
        halo = [m for m in text.splitlines()
                if "B2 row_rings=False / B3 rings launches:" in m]
        a, b = (int(x) for x in halo[-1].split(": ")[-1].split("/"))
        if not (a > 0 and b > 0):
            raise AssertionError(f"59 halo launches {a}/{b}")
        log("59 spatial train", f"train_torch.py {FLAGSHIP_YAML.name} "
            f"(attention none, use_mask false, folded) on mesh_shape "
            f"{{spatial: 2}}, {IMG}px b8 bfloat16, 2 ranks over gloo on the "
            f"one card: 3 steps in {wall:.1f}s wall (build, start and "
            f"loading included), total_loss "
            f"{[round(ln['total_loss'], 4) for ln in lines]}; one "
            f"checkpoint (3), 3 loss lines (rank 0); rank 0's B2 "
            f"row_rings=False / B3 rings launches {a}/{b}")
        return a, b


# ---------------------------------------------------------------------------
# slice 8b: row-sharded SANet serving, the model axis, the daemon over ranks
# ---------------------------------------------------------------------------

SLICE8B_FIXTURE = REPO / "tests" / "fixtures" / "torch_port_slice8b.npz"
# the fixture's SANet cases (tools/make_torch_port_fixture.py SANET_SPATIAL)
SANET_8B = {"sanet_f32": ("sanet", "aea", "float32"),
            "sanet_bf16": ("sanet", "aea", "bfloat16"),
            "dynamic_sanet_aea": ("dynamic_sanet", "aea", "float32"),
            "dynamic_sanet_relu": ("dynamic_sanet", "relu", "float32")}
# the 512px row-sharded cases of phase 60
SANET_8B_512 = ("sanet_f32", "sanet_bf16", "dynamic_sanet_relu")
# B6a on one row share of a 512px relu4_1 on {spatial: 2}
B6_SHARD_SHAPE = (1, 2048, 4096, 512)
# the flagship's layer at the model axis's share width: (N, Hf, Wf, 4C ->
# 4Co / 2) at 512px, hidden 32 on {model: 2}
TP_SHARE_SHAPE = (1, 256, 256, 128, 64)
# the aea module's limit (its sigmoid at scale 50 amplifies the thresholds'
# float32 rounding; tests/test_torch_dynamic_sanet.py holds rpst's aea
# stylize to it)
AEA_TOL = 1e-3
# the sanet step on {model: 2}: image size, and its gradients' limit as a
# share of the model's largest gradient (one device's own float32 step moves
# by 3-6e-4 of it between 1 and 4 CPU threads at tests/test_torch_tp.py's
# widths)
SANET_TP_SIZE = 256
SANET_TP_GRAD_REL = 1e-3


def _sanet_case(case, size, dev, seed=0):
    """(bundle, content, style) of a SANET_8B case at ``size`` px, batch 1:
    weights from the bridge's seeds, the 5-stage VGG from
    ``vgg_weights_from_seed(1, 5)``, the images numpy's ``default_rng(seed)``
    (the fixture's point at 64px)."""
    import numpy as np
    import torch
    from rpst_torch.bridge import (dynamic_sanet_weights_from_seed,
                                   from_flax_params, sanet_weights_from_seed,
                                   vgg_from_flax, vgg_weights_from_seed)
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.vgg import VGG19Encoder
    net, ada, dt = SANET_8B[case]
    cfg = load_config(dict(network=net, ada_module=ada, img_size=size,
                           vgg="", compute_dtype=dt,
                           adaptive_blockwise="always"))
    bundle = build_model(cfg, dev)
    tree = (sanet_weights_from_seed(seed) if net == "sanet"
            else dynamic_sanet_weights_from_seed(seed, size))
    bundle.load_state_dict(from_flax_params(tree))
    vgg = VGG19Encoder(num_stages=5)
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(1, 5)))
    bundle.vgg = vgg.to(dev)
    gen = np.random.default_rng(seed)
    c, s = (torch.from_numpy(gen.random((1, size, size, 3), dtype=np.float32))
            .to(dev) for _ in range(2))
    return bundle, c, s


def _sanet_tp_case(dev):
    """(bundle, vgg, content, style) of the sanet step on {model: 2}:
    configs/train_static_sanet.yaml at ``SANET_TP_SIZE`` px, batch 1, in
    float32 (the yaml trains under bfloat16 autocast), the sanet fixture's
    weights (``bridge.sanet_weights_from_seed(0)``, VGG seed 1: under a torch
    default init the stylized image's relu4_1 / relu5_1 channels have no
    variance, and the normalized content loss's gradient then moves by 30%
    of its size under a 1e-6 change of the weights), the images numpy's
    ``default_rng(61)``."""
    import numpy as np
    import torch
    from rpst_torch.bridge import (from_flax_params, sanet_weights_from_seed,
                                   vgg_from_flax, vgg_weights_from_seed)
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.vgg import VGG19Encoder
    cfg = load_config(str(SANET_YAML), {
        "img_size": SANET_TP_SIZE, "vgg": "", "batch_size": 1,
        "lr_decay": 0.0, "compute_dtype": "float32"})
    bundle = build_model(cfg, dev)
    bundle.load_state_dict(from_flax_params(sanet_weights_from_seed(0)))
    vgg = VGG19Encoder(num_stages=5)
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(1, 5)))
    vgg = vgg.to(dev)
    bundle.vgg = vgg
    gen = np.random.default_rng(61)
    c, s = (torch.from_numpy(gen.random(
        (1, SANET_TP_SIZE, SANET_TP_SIZE, 3), np.float32)).to(dev)
        for _ in range(2))
    return bundle, vgg, c, s


def _gathered_grads(model):
    """Each parameter's gradient whole (a model axis's shares gathered),
    by name; every rank of the axis calls it together."""
    import torch
    from rpst_torch.dist import tp
    from rpst_torch.dist.collectives import all_gather
    out = {}
    for n, p in model.named_parameters():
        if p.grad is None:
            continue
        g, spec = p.grad.detach(), tp.spec_of(p)
        out[n] = g.clone() if spec is None else torch.cat(
            all_gather(g.contiguous(), spec.axis), dim=spec.dim)
    return out


def _tp_steps(bundle, vgg, c, s, mesh, steps, on_step1=None):
    """``steps`` train_steps on ``mesh``'s model axis (the model already
    sharded): per step the loss parts and this rank's B1 / B2 / B3 / B6b-d
    launches; the step-1 gradients whole (``_gathered_grads``, taken
    before the Adam step); the state."""
    import torch
    from rpst_torch.train.step import create_train_state, train_step
    state = create_train_state(bundle, mesh=mesh)
    seen = {}

    def keep(opt, *_):
        if not seen:
            seen.update(_gathered_grads(bundle.model))
    state.optimizer.register_step_pre_hook(keep)
    cnt = _counters()
    rows = []
    for _ in range(steps):
        _reset_counts()
        parts = train_step(state, vgg, c, s)
        torch.cuda.synchronize()
        rows.append({"parts": {k: float(v) for k, v in parts.items()},
                     "launches": [cnt[k].launches for k in
                                  ("B1", "B2", "B3", "B6b", "B6c", "B6d")]})
    return rows, seen, state


def slice8b_rank(rank, init, out_dir):
    """Phases 60-61, one rank (``python3 chip_smoke.py --slice8b-rank R INIT
    OUT``): joins the other rank over gloo on the one card. Phase 60: the
    fixture's SANet cases at 64px and three at 512px on {spatial: 2}
    (``stylize_sanet_spatial``), each 512px stylize's B6a launches on this
    rank. Phase 61 on {model: 2}: the flagship at 512px b2, 3 steps folded
    and 3 standard (loss parts, launches per step, step-1 gradients whole,
    the bytes this rank stores), the folded run's checkpoint (rank 0
    writes) and its column-parallel stylize after the steps; one sanet
    step at 256px b1. Saves ``<out>/rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO / "src"))
    from rpst_torch.dist import make_mesh, shard_batch, tp
    from rpst_torch.dist.collectives import all_gather
    from rpst_torch.models.fast_path import live_folded_blocks
    from rpst_torch.models.fast_path_spatial import stylize_sanet_spatial
    from rpst_torch.ops.folded_conv import fused_folded_conv
    from rpst_torch.train.checkpoint import save_checkpoint
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)  # both ranks share the one card
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=2, rank=int(rank))
    res = {}
    try:
        s2 = make_mesh({"spatial": 2}, dev)
        ax = s2.axis("spatial")
        cnt = _counters()
        for case in SANET_8B:
            b, c, s = _sanet_case(case, 64, dev)
            y = stylize_sanet_spatial(b, shard_batch(c, s2, True),
                                      shard_batch(s, s2, True), s2)
            res[f"60/fx/{case}"] = torch.cat(all_gather(y, ax), dim=1)
        for case in SANET_8B_512:
            b, c, s = _sanet_case(case, IMG, dev)
            c_l, s_l = shard_batch(c, s2, True), shard_batch(s, s2, True)
            stylize_sanet_spatial(b, c_l, s_l, s2)  # warm-up
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = stylize_sanet_spatial(b, c_l, s_l, s2)
            torch.cuda.synchronize()
            res[f"60/512/{case}/ms"] = torch.tensor(
                (time.perf_counter() - t0) * 1e3)
            res[f"60/512/{case}/b6a"] = torch.tensor(
                [cnt["B6a"].launches, cnt["B6a"].launches_bf16])
            res[f"60/512/{case}/out"] = torch.cat(all_gather(y, ax), dim=1)
            del b, c, s, c_l, s_l, y
            torch.cuda.empty_cache()
        m2 = make_mesh({"model": 2}, dev)
        for strat in ("folded", "standard"):
            bundle, vgg, c, s = _flagship_512(dev, exec_strategy=strat)
            n_params = sum(p.numel() for p in bundle.model.parameters())
            whole = (tp.stored_numel(bundle.model) + 2 * n_params) * 4
            tp.shard_model(bundle.model, m2.axis("model"))
            rows, grads, state = _tp_steps(bundle, vgg, c, s, m2, 3)
            key = f"61/{strat}"
            res[f"{key}/losses"] = torch.tensor(
                [[r["parts"][k] for k in ("content_loss", "style_loss",
                                          "total_loss")] for r in rows])
            res[f"{key}/launches"] = torch.tensor(
                [r["launches"] for r in rows])
            res[f"{key}/bytes"] = torch.tensor(
                [tp.stored_numel(bundle.model, state.optimizer) * 4, whole])
            for n, g in grads.items():
                res[f"{key}/grads/{n}"] = g
            if strat == "folded":
                path = save_checkpoint(Path(out_dir) / "ckpt", state,
                                       write=int(rank) == 0)
                res["61/ckpt"] = torch.tensor(list(path.encode()),
                                              dtype=torch.uint8)
                bundle.model.eval()
                with torch.no_grad():
                    res["61/tp_out"] = bundle.stylize_folded(
                        live_folded_blocks(bundle.model, torch.float32),
                        None, c, s, torch.float32,
                        conv=tp.folded_column(
                            lambda x, k, b: fused_folded_conv(x, k, b, 0.2)))
            del bundle, vgg, c, s, state, grads
            torch.cuda.empty_cache()
        bundle, vgg, c, s = _sanet_tp_case(dev)
        tp.shard_model(bundle.model, m2.axis("model"))
        bundle.model.train()
        rows, grads, _ = _tp_steps(bundle, vgg, c, s, m2, 1)
        res["61/sanet/total_loss"] = torch.tensor(
            rows[0]["parts"]["total_loss"])
        res["61/sanet/launches"] = torch.tensor(rows[0]["launches"])
        for n, g in grads.items():
            res[f"61/sanet/grads/{n}"] = g
        dist.barrier()
    finally:
        torch.save({k: v.detach().cpu() for k, v in res.items()},
                   Path(out_dir) / f"rank{rank}.pt")
        dist.destroy_process_group()


def _b6a_shard(dev, name_power):
    """Phase 60's kernel check: B6a at ``B6_SHARD_SHAPE`` (one row share's
    queries against the whole style), float32 and bfloat16, against its
    plain version, timed beside it and beside F.scaled_dot_product_attention
    (scale 1.0); the bound is the operations 4 Nq Nk C at the type's peak or
    the bytes of q, k, v and O. Returns the kernels JSON numbers by type."""
    import torch
    from rpst_torch.ops import flash_attention as fa
    n, nq, nk, c = B6_SHARD_SHAPE
    out = {}
    for dtype, tol, kind, size in ((torch.float32, F32_TOL, "f32", 4),
                                   (torch.bfloat16, BF16_TOL, "bf16", 2)):
        q, k, v, _ = _attention_inputs(dev, dtype, n, nq, nk, c)
        with torch.no_grad():
            o = fa.flash_fwd(q, k, v)
            torch.cuda.synchronize()
            ref, _ = fa.flash_fwd_lse_plain(q, k, v)
            err, _ = check_close(f"60 B6a shard {kind}", o, ref, tol)
            ms = cuda_ms(lambda: fa.flash_fwd(q, k, v), iters=10)
            plain = cuda_ms(lambda: fa.flash_fwd_lse_plain(q, k, v),
                            iters=3, warmup=1)
            lib = cuda_ms(lambda: _sdpa(q, k, v), iters=10)
        qb, kb = n * nq * c * size, n * nk * c * size
        b_ms, b_by = bound_ms(4 * n * nq * nk * c, qb + 2 * kb + qb, kind)
        log("60 sanet spatial", f"B6a one row share {B6_SHARD_SHAPE} {kind}: "
            f"max abs err {err:.3g} vs plain (tol {tol}); {ms:.4f} ms vs "
            f"plain {plain:.4f}, SDPA {lib:.4f}; bound {b_ms:.4f} ms by "
            f"{b_by} ({100 * b_ms / ms:.1f}% of it; {name_power})")
        out[kind] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
        del q, k, v, o, ref
        torch.cuda.empty_cache()
    return out


def _tp_share_kernels(dev, name_power):
    """Phase 61's kernel check: B1, B2 and B3 (listed) at the flagship's
    share width on {model: 2}, ``TP_SHARE_SHAPE`` f32 with a folded kernel,
    against their plain versions, timed beside them and beside the library
    call on the ring-padded folded tensor (F.conv2d, conv2d_input,
    conv2d_weight); the bound ``folded_bound`` of the 36 listed blocks.
    Returns the kernels JSON numbers per kernel."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight
    from rpst_torch.ops.folded import fold_bias, folded_reflect_pad
    from rpst_torch.ops.folded_conv import (
        fused_folded_conv, fused_folded_conv_grad_input,
        fused_folded_conv_grad_input_plain, fused_folded_conv_grad_weight,
        fused_folded_conv_grad_weight_plain, fused_folded_conv_plain)
    g = torch.Generator().manual_seed(61)
    n, h, w, c4, c4o = TP_SHARE_SHAPE
    x, gz, khat = _grad_case(g, dev, n, h, w, c4, c4o, True)
    kf = khat.flip(0, 1).transpose(2, 3).contiguous()
    b = fold_bias(torch.randn(c4o // 4, generator=g).to(dev) * 0.1)
    xp = folded_reflect_pad(x).permute(0, 3, 1, 2)
    gp = gz.permute(0, 3, 1, 2)
    wf = kf.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = fused_folded_conv(x, kf, b, 0.2)
        dx = fused_folded_conv_grad_input(gz, khat)
        torch.cuda.synchronize()
        err = {"B1": check_close("61 B1 share", y, fused_folded_conv_plain(
                   x, kf, b, 0.2), F32_TOL)[0],
               "B2": check_close("61 B2 share", dx,
                                 fused_folded_conv_grad_input_plain(gz, khat),
                                 F32_TOL)[0],
               "B3": _check_b3("61 share f32", x, gz,
                               DK_ATOL_512 * (n * h * w / 512) ** 0.5)}
        t = {"B1": (lambda: fused_folded_conv(x, kf, b, 0.2),
                    lambda: fused_folded_conv_plain(x, kf, b, 0.2),
                    lambda: F.conv2d(xp, wf, b)),
             "B2": (lambda: fused_folded_conv_grad_input(gz, khat),
                    lambda: fused_folded_conv_grad_input_plain(gz, khat),
                    lambda: conv2d_input(xp.shape, wf, gp)),
             "B3": (lambda: fused_folded_conv_grad_weight(x, gz, True),
                    lambda: fused_folded_conv_grad_weight_plain(x, gz, True),
                    lambda: conv2d_weight(xp, (c4o, c4, 3, 3), gp))}
        out = {}
        bnd = folded_bound(n, h, w, c4, c4o, "f32", 4, True)
        for key, (kern, plain, lib) in t.items():
            ms, p_ms, l_ms = (cuda_ms(kern), cuda_ms(plain, iters=5),
                              cuda_ms(lib))
            log("61 model axis", f"{key} at the share width {TP_SHARE_SHAPE}"
                f" f32 folded: max abs err {err[key]:.3g} vs plain; "
                f"{ms:.4f} ms vs plain {p_ms:.4f}, library {l_ms:.4f}; "
                f"bound {bnd[0]:.4f} ms by {bnd[1]} ({100 * bnd[0] / ms:.1f}% "
                f"of it; {name_power})")
            out[key] = {"max_abs_err": err[key], "ms": ms, "plain_ms": p_ms,
                        "bound_ms": bnd[0], "bound_by": bnd[1],
                        "library_ms": l_ms}
    return out


def _slice8b_ranks(dev, name_power):
    """Phases 60-61: two ranks on the one card over gloo
    (``slice8b_rank``), checked here against the one-device paths on the
    card and rpst's fixture. 60: the 64px cases against rpst's
    ``stylize_sanet_spatial`` (float32 1e-4, aea 1e-3, bfloat16 MAE 1e-2 or
    3x rpst's own bfloat16 distance); at 512px float32 against the
    one-device stylize (1e-4; dynamic_sanet streamed), bfloat16 against the
    same bfloat16 function on one device (MAE 1e-2, or 3x its own bfloat16
    distance from the float32 stylize); 2 B6a a sanet stylize
    a rank (the bfloat16 kernel in bfloat16), 0 for dynamic_sanet. 61: the
    {model: 2} steps' loss parts (rtol 1e-5) and step-1 gradients (rtol
    5e-3, 1e-4 of each tensor's max: phase 9's rule) against the one-device
    step, 23 / 17 / 15 B1 / B2 / B3 a folded step a rank, the checkpoint
    served by one device equal to the ranks' column-parallel stylize
    (1e-4), and by ``serve_torch.py --weights`` within one uint8 step; the
    sanet step's gradients within ``SANET_TP_GRAD_REL`` of the largest and
    6 / 6 / 6 B6b-d a rank.
    Returns the launch counts for the kernels JSON."""
    import numpy as np
    import torch
    from PIL import Image
    from rpst_torch.bridge import load_weights
    from rpst_torch.dist import make_mesh
    from rpst_torch.models.fast_path_spatial import stylize_sanet_spatial
    torch.cuda.empty_cache()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--slice8b-rank",
         str(r), str(tmp / "init"), str(tmp)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=str(REPO))
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("phases 60-61 ranks failed:\n" + "\n".join(
            f"--- rank {r}\n{t[-3000:]}" for r, t in enumerate(logs)))
    res = [torch.load(tmp / f"rank{r}.pt", weights_only=True)
           for r in range(2)]
    log("time", f"phases 60-61 ranks {time.perf_counter() - t0:.1f}s")
    counts = {"B6a": 0, "B6a_bf16": 0, "B1": 0, "B2": 0, "B3": 0, "B6b": 0,
              "B6c": 0, "B6d": 0}
    # ---- 60 ---------------------------------------------------------------
    with np.load(SLICE8B_FIXTURE) as npz:
        fx = {k: npz[k] for k in npz.files if k.endswith("/out")}
    own = float(np.abs(fx["sanet_bf16/out"] - fx["sanet_f32/out"]).mean())
    for case in SANET_8B:
        got = res[0][f"60/fx/{case}"]
        if not torch.equal(got, res[1][f"60/fx/{case}"]):
            raise AssertionError(f"60 fixture {case}: the ranks differ")
        ref = torch.from_numpy(fx[f"{case}/out"])
        if case == "sanet_bf16":
            mae = float((got - ref).abs().mean())
            if not mae <= max(1e-2, 3 * own):
                raise AssertionError(f"60 fixture {case}: MAE {mae}")
            text = f"MAE {mae:.3g} (limit {max(1e-2, 3 * own):.3g})"
        else:
            tol = AEA_TOL if case == "dynamic_sanet_aea" else F32_TOL
            err, _ = check_close(f"60 fixture {case}", got, ref, tol)
            text = f"max abs err {err:.3g} (tol {tol})"
        log("60 sanet spatial", f"{case} 64px on {{spatial: 2}} vs rpst's "
            f"stylize_sanet_spatial: {text}")
    for case in SANET_8B_512:
        got = res[0][f"60/512/{case}/out"]
        b, c, s = _sanet_case(case, IMG, dev)
        with torch.inference_mode():
            if case == "sanet_bf16":
                ref = stylize_sanet_spatial(b, c, s, make_mesh(
                    {"spatial": 1}, dev)).cpu()
                b32, _, _ = _sanet_case("sanet_f32", IMG, dev)
                own = float((b32.stylize(c, s).cpu() - ref).abs().mean())
                del b32
            else:
                ref = b.stylize(c, s).cpu()
        del b, c, s
        torch.cuda.empty_cache()
        if case == "sanet_bf16":
            # the bf16 rule (ROADMAP section C): MAE 1e-2, or 3x the
            # function's own bf16 distance (its bf16 against the f32
            # stylize on one device)
            mae = float((got - ref).abs().mean())
            if not mae <= max(1e-2, 3 * own):
                raise AssertionError(f"60 {case} 512: MAE {mae}, own "
                                     f"bf16 distance {own}")
            text = (f"MAE {mae:.3g} vs the same bf16 function on one device "
                    f"(limit {max(1e-2, 3 * own):.3g}: its own bf16 "
                    f"distance from f32 {own:.3g})")
        else:
            err, _ = check_close(f"60 {case} 512", got, ref, F32_TOL)
            text = f"max abs err {err:.3g} vs the one-device stylize"
        want = {"sanet_f32": [2, 0], "sanet_bf16": [2, 2],
                "dynamic_sanet_relu": [0, 0]}[case]
        per_rank = [res[r][f"60/512/{case}/b6a"].tolist() for r in range(2)]
        if any(pr != want for pr in per_rank):
            raise AssertionError(f"60 {case}: B6a launches (all, bf16) a "
                                 f"rank {per_rank}, expected {want}")
        counts["B6a"] += sum(pr[0] - pr[1] for pr in per_rank)
        counts["B6a_bf16"] += sum(pr[1] for pr in per_rank)
        log("60 sanet spatial", f"{case} {IMG}px b1 on {{spatial: 2}}: "
            f"{text}; B6a launches (of them bf16) per rank {per_rank}; "
            f"stylize {float(res[0][f'60/512/{case}/ms']):.1f} ms on rank 0 "
            f"(two ranks share the card; {name_power})")
    b6_shard = _b6a_shard(dev, name_power)
    # ---- 61 ---------------------------------------------------------------
    share = _tp_share_kernels(dev, name_power)
    for strat in ("folded", "standard"):
        key = f"61/{strat}"
        bundle, vgg, c, s = _flagship_512(dev, exec_strategy=strat)
        single = _mesh_step(bundle, vgg, c, s, None)
        del bundle, vgg
        for r in range(2):
            loss = float(res[r][f"{key}/losses"][0, 2])
            if not np.isclose(loss, single[0], rtol=1e-5):
                raise AssertionError(f"61 {strat} rank {r} loss {loss} vs "
                                     f"{single[0]}")
            got = {n[len(f"{key}/grads/"):]: v for n, v in res[r].items()
                   if n.startswith(f"{key}/grads/")}
            worst = _check_grad_rule(f"61 {strat} rank {r}", got, single[1],
                                     {})
        launches = [res[r][f"{key}/launches"].tolist() for r in range(2)]
        want = [23, 17, 15] if strat == "folded" else [0, 0, 0]
        if any(row[:3] != want for per in launches for row in per):
            raise AssertionError(f"61 {strat}: B1/B2/B3 launches per step "
                                 f"a rank {launches}, expected {want}")
        for i, k in enumerate(("B1", "B2", "B3")):
            counts[k] += sum(row[i] for per in launches for row in per)
        stored, whole = res[0][f"{key}/bytes"].tolist()
        losses = res[0][f"{key}/losses"][:, 2].tolist()
        log("61 model axis", f"flagship {IMG}px b2 {strat} on {{model: 2}}, "
            f"3 steps: total_loss {[round(v, 6) for v in losses]} (one "
            f"device's step 1 {single[0]:.6g}); step-1 gradients worst "
            f"{worst:.3g} x max; B1/B2/B3 a step a rank "
            f"{[per[0][:3] for per in launches]}; parameters + Adam state "
            f"{stored / 2 ** 20:.2f} MiB a rank against {whole / 2 ** 20:.2f} "
            f"MiB on one device")
    ckpt = Path(res[0]["61/ckpt"].numpy().tobytes().decode())
    bundle, _, c, s = _flagship_512(dev)
    bundle.load_state_dict(load_weights(ckpt / "state.pt"))
    bundle.model.eval()
    with torch.inference_mode():
        served = bundle.stylize(c, s).cpu()
    err, _ = check_close("61 checkpoint served", served, res[0]["61/tp_out"],
                         F32_TOL)
    # serve_torch.py on one device reads the checkpoint
    (tmp / "c").mkdir()
    u8 = lambda t: (torch.clamp(t, 0, 1) * 255 + 0.5).to(  # noqa: E731
        torch.uint8).cpu().numpy()
    Image.fromarray(u8(c[0])).save(tmp / "c" / "c0.png")
    Image.fromarray(u8(s[0])).save(tmp / "s.png")
    cfg_path = tmp / "cfg.yaml"
    cfg_path.write_text(json.dumps(dict(SPATIAL_SRC["multi_adain"][1],
                                        img_size=IMG)))
    proc = subprocess.run(
        [sys.executable, str(REPO / "serve_torch.py"), "--config",
         str(cfg_path), "--content", str(tmp / "c"), "--style",
         str(tmp / "s.png"), "--out", str(tmp / "srv"), "--mode", "folded",
         "--batch", "1", "--device", "cuda", "--weights",
         str(ckpt / "state.pt")], capture_output=True, text=True,
        timeout=300, cwd=str(REPO))
    if proc.returncode:
        raise AssertionError(f"61 serve_torch --weights rc "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    png = np.asarray(Image.open(tmp / "srv" / "c0-s.png")).astype(int)
    cu, su = (torch.from_numpy(np.asarray(Image.open(p))).to(dev)[None]
              .float() / 255 for p in (tmp / "c" / "c0.png", tmp / "s.png"))
    with torch.inference_mode():
        want_png = u8(bundle.stylize(cu, su)[0]).astype(int)
    step = int(np.abs(png - want_png).max())
    if step > 1:
        raise AssertionError(f"61 serve_torch PNG off by {step} steps")
    del bundle
    log("61 model axis", f"checkpoint {ckpt.name} (one-device layout) "
        f"served by one device equals the ranks' column-parallel stylize: "
        f"max abs err {err:.3g}; serve_torch.py --mode folded --weights "
        f"state.pt within {step} uint8 step")
    # the sanet step on {model: 2}
    bundle, vgg, c, s = _sanet_tp_case(dev)
    bundle.model.train()
    single = _mesh_step(bundle, vgg, c, s, None)
    # float32 decides here (softmax logits near 8 and the VGG's dead
    # channels amplify rounding): each gradient within rtol 5e-3 and
    # SANET_TP_GRAD_REL of the model's largest gradient, as
    # tests/test_torch_tp.py holds the SANets on the CPU
    largest = max(float(g.abs().max()) for g in single[1].values())
    worst = 0.0
    for r in range(2):
        loss = float(res[r]["61/sanet/total_loss"])
        if not np.isclose(loss, single[0], rtol=1e-5):
            raise AssertionError(f"61 sanet rank {r} loss {loss} vs "
                                 f"{single[0]}")
        for n, ref in single[1].items():
            got = res[r][f"61/sanet/grads/{n}"].double()
            ref = ref.double().cpu()
            err = float((got - ref).abs().max())
            if not torch.allclose(got, ref, rtol=GRAD_RTOL,
                                  atol=SANET_TP_GRAD_REL * largest):
                raise AssertionError(f"61 sanet {n}: max abs err {err} "
                                     f"({err / largest:.3g} of the largest "
                                     "gradient)")
            worst = max(worst, err / largest)
    b6 = [res[r]["61/sanet/launches"].tolist()[3:] for r in range(2)]
    if any(x != [6, 6, 6] for x in b6):
        raise AssertionError(f"61 sanet: B6b/c/d launches a rank {b6}")
    for i, k in enumerate(("B6b", "B6c", "B6d")):
        counts[k] += sum(x[i] for x in b6)
    log("61 model axis", f"sanet {SANET_TP_SIZE}px b1 on {{model: 2}}, one "
        f"step: loss "
        f"{float(res[0]['61/sanet/total_loss']):.6g} (one device "
        f"{single[0]:.6g}), gradients worst {worst:.3g} of the largest "
        f"(limit {SANET_TP_GRAD_REL}); B6b/c/d a rank {b6}")
    tmp_dir.cleanup()
    return counts, b6_shard, share


def _mesh_daemon(dev):
    """Phase 62: serve_torch.py --daemon --mesh 2 on the flagship folded at
    512px, batch 2, its two ranks on the one card over {data: 2}: 4
    requests over TCP, every PNG within one uint8 step of the one-device
    folded stylize of the same images in this process (the weights
    serve_torch.py seeds without --weights), and a shutdown that every rank
    obeys (exit code 0)."""
    import numpy as np
    import torch
    from PIL import Image
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.blocks import init_torch_default
    rng = np.random.default_rng(62)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "content").mkdir()
        (tmp / "style").mkdir()
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                            "RGB").save(tmp / "content" / f"c{i}.png")
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8),
                        "RGB").save(tmp / "style" / "s.png")
        cfg_path = tmp / "cfg.yaml"
        cfg_path.write_text(json.dumps(dict(FLAGSHIP, img_size=IMG)))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "serve_torch.py"), "--config",
             str(cfg_path), "--content", str(tmp / "content"), "--style",
             str(tmp / "style" / "s.png"), "--out", str(tmp / "mesh"),
             "--mode", "folded", "--batch", "2", "--device", "cuda",
             "--daemon", "--port", "0", "--max-wait-ms", "200", "--mesh",
             "2"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=str(REPO))
        try:
            port, lines = None, []
            deadline = time.time() + 300
            while time.time() < deadline and port is None:
                line = proc.stdout.readline()
                if not line:
                    break
                lines.append(line)
                if "DAEMON LISTENING" in line:
                    port = int(line.split("DAEMON LISTENING")[1].split()[0]
                               .rsplit(":", 1)[1])
            if port is None:
                raise AssertionError("62 daemon did not start:\n"
                                     + "".join(lines[-40:]))
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=300) as sock:
                f = sock.makefile("rw")
                for i in range(4):
                    f.write(json.dumps({"id": f"r{i}", "content": str(
                        tmp / "content" / f"c{i}.png")}) + "\n")
                f.flush()
                replies = [json.loads(f.readline()) for _ in range(4)]
                f.write(json.dumps({"cmd": "shutdown"}) + "\n")
                f.flush()
                if not json.loads(f.readline()).get("shutdown"):
                    raise AssertionError("62: no shutdown reply")
            rest, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        wall = time.perf_counter() - t0
        if proc.returncode != 0 or not all(r.get("ok") for r in replies):
            raise AssertionError(f"62 daemon rc {proc.returncode}, replies "
                                 f"{replies}:\n" + (rest or "")[-3000:])
        cfg = load_config(str(cfg_path), {"exec_strategy": "folded"})
        bundle = build_model(cfg, dev)
        init_torch_default(bundle.model, cfg.seed)
        u8 = lambda p: torch.from_numpy(np.asarray(  # noqa: E731
            Image.open(p)).copy()).to(dev)[None].float() / 255
        style = u8(tmp / "style" / "s.png")
        step = 0
        with torch.inference_mode():
            for r in replies:
                i = int(r["id"][1:])
                y = bundle.stylize(u8(tmp / "content" / f"c{i}.png"), style)
                want = (torch.clamp(y[0], 0, 1) * 255 + 0.5).to(
                    torch.uint8).cpu().numpy().astype(int)
                got = np.asarray(Image.open(r["out"])).astype(int)
                step = max(step, int(np.abs(got - want).max()))
        if step > 1:
            raise AssertionError(f"62 mesh daemon PNGs off by {step} steps")
    log("62 daemon", f"serve_torch.py --daemon --mesh 2 (flagship folded "
        f"{IMG}px, batch 2, two ranks on the one card): 4 requests answered, "
        f"every PNG within {step} uint8 step of the one-device folded "
        f"stylize; shutdown stopped both ranks (exit 0); {wall:.1f}s wall "
        f"with the ranks' start")

# ---- slice 8c: row-sharded serving of the standard layout -----------------
STD_8C = ("adain", "wct", "mrf", "spade", "seg_adain", "src") + LD_NETWORKS
STD_8C_BF16 = ("adain", "ld_adain")
SLICE8C_FIXTURE = REPO / "tests" / "fixtures" / "torch_port_slice8c.npz"
# the fixture's point: rpst's tests/test_spatial_gspmd.py _TINY (the table
# of tools/make_torch_port_fixture.py TINY_8C / CASES_8C), the LD family
# with use_mask off
TINY_8C = dict(img_size=32, rp_blocks=2, hidden_dim=8, inception_num=0,
               attention="none", compute_dtype="float32", vgg="")


def _fx_8c_bundle(network, dev):
    """A STD_8C network at the slice-8c fixture's point: ``TINY_8C``, the
    family's seeded draw (``bridge.weights_from_seed(cfg, 0)``), src's VGG
    from ``vgg_weights_from_seed(1)``."""
    from rpst_torch.bridge import (from_flax_params, vgg_from_flax,
                                   vgg_weights_from_seed, weights_from_seed)
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.vgg import VGG19Encoder
    over = {"use_mask": False} if network in LD_NETWORKS else {}
    cfg = load_config(dict(TINY_8C, network=network, **over))
    bundle = build_model(cfg, dev)
    bundle.load_state_dict(from_flax_params(weights_from_seed(cfg, 0)))
    if bundle.from_features:
        vgg = VGG19Encoder()
        vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(1)))
        bundle.vgg = vgg.to(dev)
    return bundle


def _std_8c_bundle(network, dev, dtype="float32"):
    """A STD_8C network at 512px at the widths the earlier phases serve it
    at, seeded: adain / wct at bench.py's (``_rpseq_bundle``), mrf / spade
    / seg_adain at bench.py's (``_5b_bundle``), src on its yaml with
    use_mask off (``_6b_bundle``), the LD family at its yamls'
    (``_ld_bundle``); in compute_dtype ``dtype``."""
    over = {"compute_dtype": dtype}
    if network in ("adain", "wct"):
        return _rpseq_bundle(network, dev, IMG, **over)
    if network in S5B_NETWORKS:
        return _5b_bundle(dev, network, IMG, **over)
    if network == "src":
        return _6b_bundle(dev, "src", IMG, **over)
    return _ld_bundle(dev, network, IMG, **over)


def _images_8c(dev):
    """The 512px b1 content and style of phase 63 (numpy's
    ``default_rng(63)``)."""
    import numpy as np
    import torch
    gen = np.random.default_rng(63)
    return tuple(torch.from_numpy(gen.random((1, IMG, IMG, 3), np.float32))
                 .to(dev) for _ in range(2))


def _runs_8c():
    return ([(n, "float32") for n in STD_8C]
            + [(n, "bfloat16") for n in STD_8C_BF16])


def slice8c_rank(rank, init, out_dir):
    """Phase 63, one rank (``python3 chip_smoke.py --slice8c-rank R INIT
    OUT``): joins the other rank over gloo on the one card and serves
    every STD_8C network's standard layout on {spatial: 2} through
    ``serving.make_mesh_run_impl`` (the CLI's and the daemon's run
    function): at the slice-8c fixture's point (32px b2), then at 512px b1
    (float32 for all, bfloat16 for adain and LD v1) after one warm-up
    call, timed; then phase 64's training (``_train_64_rank``). Saves
    ``<out>/rank<r>.pt``: the gathered outputs, the timed call's ms and
    each network's wall seconds on this rank, every kernel's launches in
    phase 63 (none expected), and phase 64's readings."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO / "src"))
    from rpst_torch.dist import make_mesh
    from rpst_torch.serving import make_mesh_run_impl
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)  # both ranks share the one card
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=2, rank=int(rank))
    res = {}
    try:
        s2 = make_mesh({"spatial": 2}, dev)
        _reset_counts()
        with np.load(SLICE8C_FIXTURE) as npz:
            c, s = (torch.from_numpy(npz[k]).to(dev).float() / 255
                    for k in ("content", "style"))
        for net in STD_8C:
            run = make_mesh_run_impl(_fx_8c_bundle(net, dev), "standard", s2)
            res[f"63/fx/{net}"] = run(c, s)
        c, s = _images_8c(dev)
        for net, dt in _runs_8c():
            t_net = time.perf_counter()
            run = make_mesh_run_impl(_std_8c_bundle(net, dev, dt),
                                     "standard", s2)
            run(c, s)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = run(c, s)
            torch.cuda.synchronize()
            key = f"63/512/{net}/{dt}"
            res[f"{key}/ms"] = torch.tensor((time.perf_counter() - t0) * 1e3)
            res[f"{key}/out"] = y
            res[f"{key}/wall_s"] = torch.tensor(time.perf_counter() - t_net)
            del run, y
            torch.cuda.empty_cache()
        res["63/launches"] = torch.tensor(
            [c.launches for c in _counters().values()])
        dist.barrier()
        t0 = time.perf_counter()
        _train_64_rank(rank, res, dev, s2)
        res["64/rank_s"] = torch.tensor(time.perf_counter() - t0)
        dist.barrier()
    finally:
        torch.save({k: v.detach().cpu() for k, v in res.items()},
                   Path(out_dir) / f"rank{rank}.pt")
        dist.destroy_process_group()


def _slice8c_ranks(dev, name_power):
    """Phase 63: the standard layout of adain, wct, mrf, spade, seg_adain,
    src and LD v1-v5 served row-sharded by two ranks on the one card over
    gloo (``slice8c_rank``, whose processes then run phase 64's training:
    their results are returned for ``_slice8c_train_check``), rpst's
    GSPMD route made explicit. At the
    fixture's point each output within one uint8 step of rpst's
    single-device and GSPMD serving (``torch_port_slice8c.npz``) and its
    float32 within 1e-4 of rpst's single-device stylize; at 512px b1 each
    float32 output within 1e-4 of the one-device stylize on the card, the
    bfloat16 ones (adain, LD v1) within MAE 1e-2 or 3x the one-device
    bfloat16 distance from float32 (the bf16 rule of ROADMAP section C);
    no kernel of the port launched on either rank (rpst's route reaches no
    Pallas call). Logs each network's sharded and one-device ms and a
    ``[time]`` line per network."""
    import numpy as np
    import torch
    torch.cuda.empty_cache()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--slice8c-rank",
         str(r), str(tmp / "init"), str(tmp)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=str(REPO))
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("phase 63 ranks failed:\n" + "\n".join(
            f"--- rank {r}\n{t[-3000:]}" for r, t in enumerate(logs)))
    res = [torch.load(tmp / f"rank{r}.pt", weights_only=True)
           for r in range(2)]
    tmp_dir.cleanup()
    log("time", f"phase 63 ranks {time.perf_counter() - t0:.1f}s")
    for r in range(2):
        if int(res[r]["63/launches"].sum()):
            raise AssertionError(f"63: rank {r} launched kernels of the "
                                 f"port: {res[r]['63/launches'].tolist()}")
    u8 = lambda t: (np.clip(t, 0.0, 1.0) * 255.0 + 0.5).astype(  # noqa
        np.uint8).astype(int)
    with np.load(SLICE8C_FIXTURE) as npz:
        fx = {k: npz[k] for k in npz.files}
    for net in STD_8C:
        got = res[0][f"63/fx/{net}"]
        if not torch.equal(got, res[1][f"63/fx/{net}"]):
            raise AssertionError(f"63 fixture {net}: the ranks differ")
        steps = [int(np.abs(u8(got.numpy()) - fx[f"{net}/{k}"].astype(
            int)).max()) for k in ("one", "s2")]
        if max(steps) > 1:
            raise AssertionError(f"63 fixture {net}: uint8 steps from rpst's "
                                 f"one device / GSPMD {steps}")
        err, _ = check_close(f"63 fixture {net}", got,
                             torch.from_numpy(fx[f"{net}/one_f32"]), F32_TOL)
        log("63 std spatial", f"{net} 32px b2 on {{spatial: 2}} vs rpst: "
            f"uint8 steps from its one device / GSPMD {steps}, float32 max "
            f"abs err {err:.3g} from its one-device stylize")
    c, s = _images_8c(dev)
    f32_ref = {}
    for net, dt in _runs_8c():
        t_net = time.perf_counter()
        key = f"63/512/{net}/{dt}"
        got = res[0][f"{key}/out"]
        if not torch.equal(got, res[1][f"{key}/out"]):
            raise AssertionError(f"{key}: the ranks differ")
        bundle = _std_8c_bundle(net, dev, dt)
        with torch.inference_mode():
            bundle.stylize(c, s, folded=False)  # warm-up
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref = bundle.stylize(c, s, folded=False)
            torch.cuda.synchronize()
            one_ms = (time.perf_counter() - t1) * 1e3
        ref = ref.cpu()
        del bundle
        torch.cuda.empty_cache()
        if dt == "float32":
            f32_ref[net] = ref
            err, _ = check_close(key, got, ref, F32_TOL)
            text = f"max abs err {err:.3g} vs the one-device stylize"
        else:
            own = float((ref - f32_ref[net]).abs().mean())
            mae = float((got - ref).abs().mean())
            if not mae <= max(1e-2, 3 * own):
                raise AssertionError(f"{key}: MAE {mae}, own bf16 distance "
                                     f"{own}")
            text = (f"MAE {mae:.3g} vs the one-device bf16 stylize (limit "
                    f"{max(1e-2, 3 * own):.3g}: its own bf16 distance from "
                    f"f32 {own:.3g})")
        ms = float(res[0][f"{key}/ms"])
        log("63 std spatial", f"{net} {IMG}px b1 {dt} on {{spatial: 2}}: "
            f"{text}; {ms:.1f} ms a stylize on rank 0 with the rows' "
            f"gather, {one_ms:.1f} ms on one device (two ranks share the "
            f"card; {name_power})")
        log("time", f"63 {net} {dt}: ranks "
            f"{float(res[0][f'{key}/wall_s']):.1f}s, one device "
            f"{time.perf_counter() - t_net:.1f}s")
    return res


# ---------------------------------------------------------------------------
# slice 8c's training half: the standard layout trained on row shares
# ---------------------------------------------------------------------------

SLICE8C_TRAIN_FIXTURE = (REPO / "tests" / "fixtures"
                         / "torch_port_slice8c_train.npz")
# the networks phase 64 trains at 256px b2 on {spatial: 2}, at their yaml /
# bench.py widths: rpst's 16 spatial_ok networks but sanet and the flagship
# multi_adain, which it trains at 512px
TRAIN_64_SIZE = 256
TRAIN_64 = (("adain", {}), ("multi_adain", {"enc_stack_way": "deeper"}),
            ("sel_multi_adain", {}), ("ccam", {}), ("wct", {}), ("mrf", {}),
            ("spade", {}), ("seg_adain", {}), ("src", {}),
            ("dynamic_sanet", {})) + tuple((n, {}) for n in LD_NETWORKS)
# the sharded step's gradients against one device's: a share of the
# model's largest gradient (float32; phase 61's rule for the SANets,
# whose float32 steps move by 3-6e-4 of it between two summation orders),
# and the float32 rule of phase 9 for the flagship (rtol 5e-3, 1e-4 of each
# tensor's max)
TRAIN_64_GRAD_REL = 1e-3


def _worker():
    """tests/torch_dist_worker.py: the fixture's point (``train_case_8c``)
    and its comparison (``compress_leaf`` / ``leaf_errors``)."""
    sys.path.insert(0, str(REPO / "tests"))
    import torch_dist_worker
    return torch_dist_worker


def _train_64_case(net, over, dev):
    """(bundle, vgg, content, style, label) of a TRAIN_64 entry at
    TRAIN_64_SIZE b2: the earlier phases' seeded bundles at their widths
    (adain / wct ``_rpseq_bundle``, mrf / spade / seg_adain ``_5b_bundle``,
    src / dynamic_sanet ``_6b_bundle``, LD ``_ld_bundle``, the multiscale
    family ``_flagship_512`` standard), the config's seeded VGG, images and
    seg_adain's labels from numpy's ``default_rng(64)``."""
    import numpy as np
    import torch
    from rpst_torch.models import build_vgg
    size = TRAIN_64_SIZE
    if net in ("adain", "wct"):
        bundle = _rpseq_bundle(net, dev, size)
    elif net in S5B_NETWORKS:
        bundle = _5b_bundle(dev, net, size)
    elif net in ("src", "dynamic_sanet"):
        bundle = _6b_bundle(dev, net, size)
    elif net in LD_NETWORKS:
        bundle = _ld_bundle(dev, net, size)
    else:
        bundle = _flagship_512(dev, net, size, 2,
                               exec_strategy="standard", **over)[0]
    vgg = bundle.vgg if bundle.from_features else build_vgg(bundle.cfg,
                                                            dev)[0]
    rng = np.random.default_rng(64)
    c, s = (torch.from_numpy(rng.random((2, size, size, 3), np.float32))
            .to(dev) for _ in range(2))
    label = (torch.from_numpy(rng.integers(
        -1, bundle.cfg.class_num, (2, size, size))).to(dev)
        if net == "seg_adain" else None)
    bundle.model.train()
    return bundle, vgg, c, s, label


def _sanet_train_case(dev, dtype):
    """(bundle, vgg, content, style, None) of configs/train_static_sanet.yaml
    at 512px b1 in compute_dtype ``dtype``: the sanet fixture's weights
    (``sanet_weights_from_seed(0)``, VGG seed 1), images numpy's
    ``default_rng(64)``."""
    import numpy as np
    import torch
    from rpst_torch.bridge import (from_flax_params, sanet_weights_from_seed,
                                   vgg_from_flax, vgg_weights_from_seed)
    from rpst_torch.config import load_config
    from rpst_torch.models import build_model
    from rpst_torch.nn.vgg import VGG19Encoder
    cfg = load_config(str(SANET_YAML), {
        "img_size": IMG, "vgg": "", "batch_size": 1, "lr_decay": 0.0,
        "compute_dtype": dtype})
    bundle = build_model(cfg, dev)
    bundle.load_state_dict(from_flax_params(sanet_weights_from_seed(0)))
    vgg = VGG19Encoder(num_stages=5)
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(1, 5)))
    bundle.vgg = vgg = vgg.to(dev)
    rng = np.random.default_rng(64)
    c, s = (torch.from_numpy(rng.random((1, IMG, IMG, 3), np.float32))
            .to(dev) for _ in range(2))
    bundle.model.train()
    return bundle, vgg, c, s, None


def _grad_step(make, mesh, timed=False):
    """One train_step (Adam, as the drivers build it) of ``make()``'s case
    on ``mesh`` (its batch share and rows) or one device: (loss parts, the
    gradients the optimizer stepped on, this rank's B6b, B6c, B6d and
    bfloat16 B6b launches in the step, and with ``timed`` the wall ms of a
    second step, synchronised, else None)."""
    import torch
    from rpst_torch.dist import shard_batch
    from rpst_torch.train.step import create_train_state, train_step
    bundle, vgg, c, s, label = make()
    if mesh is not None:
        c, s = (shard_batch(t, mesh, spatial=True) for t in (c, s))
        if label is not None:
            label = shard_batch(label, mesh, spatial=True)
    state = create_train_state(bundle, mesh=mesh)
    seen = {}
    state.optimizer.register_step_pre_hook(lambda *_: seen.update(
        {n: p.grad.detach().clone() for n, p in
         bundle.model.named_parameters() if p.grad is not None}))
    cnt = _counters()
    _reset_counts()
    parts = train_step(state, vgg, c, s, content_label=label)
    torch.cuda.synchronize()
    launches = [cnt[k].launches for k in ("B6b", "B6c", "B6d")]
    launches.append(cnt["B6b"].launches_bf16)
    ms = None
    if timed:
        grads = dict(seen)
        t0 = time.perf_counter()
        train_step(state, vgg, c, s, content_label=label)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        seen.clear()
        seen.update(grads)
    return ({k: float(v) for k, v in parts.items()}, seen,
            torch.tensor(launches), ms)


def _grad_errors(got, ref):
    """(max |got - ref| over every tensor / the largest |ref|, the worst
    tensor by phase 9's rule: max |got - ref| / (1e-4 max |ref| + 5e-3
    |ref|), above 1 fails it; a tensor zero but for rounding, under 1e-5
    of the largest, is held under 1e-4 of the largest instead)."""
    ref = {n: g for n, g in ref.items() if g.numel()}
    top = max(float(g.abs().max()) for g in ref.values())
    worst = max(float((got[n] - g).abs().max()) for n, g in ref.items())
    p9 = 0.0
    for n, g in ref.items():
        size = float(g.abs().max())
        if size < 1e-5 * top:
            p9 = max(p9, float(got[n].abs().max()) / (1e-4 * top))
        else:
            p9 = max(p9, float(((got[n] - g).abs()
                                / (1e-4 * size + 5e-3 * g.abs())).max()))
    return worst / top, p9


def _train_64_rank(rank, res, dev, s2):
    """Phase 64's work on one rank of phase 63's two (``slice8c_rank``),
    into ``res``: at the slice-8c training fixture's point (rpst's _TINY,
    32px b4) every TRAIN_8C network's SGD(1.0) step on {spatial: 2}
    (``train.step``'s rows route); then configs/train_static_sanet.yaml at
    512px b1 in float32 and bfloat16, the flagship's standard layout at
    512px b2 and TRAIN_64 at 256px b2, one step each on {spatial: 2}: its
    loss, this rank's B6b-d launches in it, and (sanet float32 and the
    flagship) a second step's wall time. The one-device steps the card
    holds them against are dealt over the two ranks after (a case whose
    index is this rank's parity; sanet bfloat16 with sanet float32, whose
    gradients give its own bfloat16 distance): their loss, ms and the
    errors of the sharded gradients against theirs."""
    import torch
    W = _worker()
    for net, over in W.TRAIN_8C:
        fid = W.family_id(net, over)
        for k, v in W.train_step_8c(net, over, s2).items():
            res[f"64/fx/s2/{fid}/{k}"] = v
    cases = [("sanet_float32", lambda: _sanet_train_case(dev, "float32")),
             ("flagship", lambda: _flagship_512(
                 dev, "multi_adain", IMG, 2, exec_strategy="standard")
              + (None,)),
             ("sanet_bfloat16", lambda: _sanet_train_case(dev, "bfloat16"))]
    cases += [(W.family_id(net, over),
               lambda net=net, over=over: _train_64_case(net, over, dev))
              for net, over in TRAIN_64]
    timed = ("sanet_float32", "flagship")
    mine = {}
    for i, (key, make) in enumerate(cases):
        t0 = time.perf_counter()
        parts, grads, launches, ms = _grad_step(make, s2, key in timed)
        res[f"64/{key}/launches"] = launches
        res[f"64/{key}/total_loss"] = torch.tensor(parts["total_loss"])
        res[f"64/{key}/rank_s"] = torch.tensor(time.perf_counter() - t0)
        if ms is not None:
            res[f"64/{key}/step_ms"] = torch.tensor(ms)
        if i % 2 == int(rank):
            mine[key] = {n: g.cpu() for n, g in grads.items()}
        del grads
        torch.cuda.empty_cache()
    f32 = None
    for key, make in cases:
        if key not in mine:
            continue
        one_parts, one_grads, _, one_ms = _grad_step(make, None,
                                                     key in timed)
        one_grads = {n: g.cpu() for n, g in one_grads.items()}
        res[f"64/{key}/one_loss"] = torch.tensor(one_parts["total_loss"])
        if one_ms is not None:
            res[f"64/{key}/one_ms"] = torch.tensor(one_ms)
        res[f"64/{key}/grad_err"] = torch.tensor(
            _grad_errors(mine.pop(key), one_grads))
        if key == "sanet_float32":
            f32 = one_grads
        elif key == "sanet_bfloat16":  # its own bfloat16 distance
            res[f"64/{key}/own"] = torch.tensor(
                _grad_errors(one_grads, f32)[0])
        del one_grads
        torch.cuda.empty_cache()


def _b6bd_shard(dev, name_power, whole=None):
    """Phase 64's kernel check: B6b (forward with LSE), B6c (dQ) and B6d
    (dK / dV) at ``B6_SHARD_SHAPE`` (one row share's queries against the
    whole style), float32 and bfloat16, against their plain versions
    (phase 23's checks), timed beside plain and
    F.scaled_dot_product_attention forward (B6b) and its autograd backward
    (B6c, B6d); the bounds of phase 23. ``whole``: phase 23's kernels JSON
    numbers by kernel at the whole image's (1, 4096, 4096, 512) in this
    run, logged beside. Returns the kernels JSON numbers of the shard by
    type and kernel."""
    import torch
    from rpst_torch.ops import flash_attention as fa
    out = {}
    n, nq, nk, c = B6_SHARD_SHAPE
    for dtype, tol, kind, size in ((torch.float32, F32_TOL, "f32", 4),
                                   (torch.bfloat16, BF16_TOL, "bf16", 2)):
        err = _b6_compare(f"64 row share {kind}", dev, dtype, B6_SHARD_SHAPE,
                          1.0, tol)
        q, k, v, d_o = _attention_inputs(dev, dtype, *B6_SHARD_SHAPE)
        with torch.no_grad():
            o, lse = fa.flash_fwd_lse(q, k, v)
            delta = (d_o.float() * o.float()).sum(-1)
            ms = {"B6b": cuda_ms(lambda: fa.flash_fwd_lse(q, k, v),
                                 iters=10),
                  "B6c": cuda_ms(lambda: fa.flash_bwd_dq(
                      q, k, v, d_o, lse, delta), iters=10),
                  "B6d": cuda_ms(lambda: fa.flash_bwd_dkv(
                      q, k, v, d_o, lse, delta), iters=10)}
            plain = {"B6b": cuda_ms(lambda: fa.flash_fwd_lse_plain(
                         q, k, v), iters=3, warmup=1),
                     "B6c": cuda_ms(lambda: fa.flash_bwd_dq_plain(
                         q, k, v, d_o, lse, delta), iters=3, warmup=1),
                     "B6d": cuda_ms(lambda: fa.flash_bwd_dkv_plain(
                         q, k, v, d_o, lse, delta), iters=3, warmup=1)}
            lib_fwd = cuda_ms(lambda: _sdpa(q, k, v), iters=10)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        graph = _sdpa(*leaves)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            graph, leaves, d_o, retain_graph=True), iters=5, warmup=2)
        del graph, leaves
        lib = {"B6b": lib_fwd, "B6c": lib_bwd, "B6d": lib_bwd}
        qb, kb, rows = n * nq * c * size, n * nk * c * size, n * nq * 4
        work = n * nq * nk * c
        bounds = {
            "B6b": bound_ms(4 * work, qb + 2 * kb + qb + rows, kind),
            "B6c": bound_ms(6 * work, 2 * qb + 2 * kb + 2 * rows + qb, kind),
            "B6d": bound_ms(8 * work, 2 * qb + 2 * kb + 2 * rows + 2 * kb,
                            kind)}
        for key in ("B6b", "B6c", "B6d"):
            b_ms, b_by = bounds[key]
            at = (whole or {}).get(key if kind == "f32" else f"{key}_bf16")
            beside = ("" if at is None else
                      f"; the whole image's {at['ms']:.4f} ms, SDPA "
                      f"{at['library_ms']:.4f} (phase 23)")
            log("64 row share", f"{key} {B6_SHARD_SHAPE} {kind}: max abs err "
                f"{err[key]:.3g} vs plain (tol {tol}); {ms[key]:.4f} ms vs "
                f"plain {plain[key]:.4f}, SDPA {lib[key]:.4f}; bound "
                f"{b_ms:.4f} ms by {b_by} ({100 * b_ms / ms[key]:.1f}% of "
                f"it){beside} ({name_power})")
            out[(kind, key)] = {
                "max_abs_err": err[key], "ms": ms[key],
                "plain_ms": plain[key], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib[key]}
        del q, k, v, d_o, o, lse, delta
        torch.cuda.empty_cache()
    return out


def _fx_64_check(res):
    """The fixture part of phase 64 against rpst's one-device and GSPMD
    steps (``torch_port_slice8c_train.npz``): every TRAIN_8C network's
    {spatial: 2} step, every rank bit-equal, its loss at rtol 1e-4 and each
    updated tensor at rpst's limits or within 1e-3 of the largest update
    (tests/test_torch_tp.py's float32 rule: cuDNN's and the shares'
    summation orders). The CPU test, tests/test_torch_std_spatial_train.py,
    holds the same steps at rpst's limits with the float32-noise rule, and
    in float64."""
    import numpy as np
    W = _worker()
    with np.load(SLICE8C_TRAIN_FIXTURE) as npz:
        fx = {k: npz[k] for k in npz.files}
    r0 = {k: v.numpy() for k, v in res[0].items()}
    for net, over in W.TRAIN_8C:
        fid = W.family_id(net, over)
        key = f"64/fx/s2/{fid}/"
        for part in ("loss", "digest"):
            if not np.array_equal(res[0][key + part], res[1][key + part]):
                raise AssertionError(f"64 fixture {fid}: the ranks differ")
        got = {}
        for k, v in r0.items():
            if k.startswith(key + "state/"):
                name, part = k[len(key) + 6:].rsplit("/", 1)
                got.setdefault(name, {})[part] = v
        loss = float(r0[key + "loss"])
        worst = 0.0
        for step in ("one", "d2s2"):
            ref_loss = float(fx[f"{fid}/{step}/loss"])
            if abs(loss - ref_loss) > 1e-4 * abs(ref_loss):
                raise AssertionError(f"64 fixture {fid}: loss {loss} vs "
                                     f"rpst's {step} {ref_loss}")
            ref = W.unpack_leaves(fx[f"{fid}/{step}/state"], got)
            largest = max(float(v["upd_max"]) for v in ref.values())
            u_tol = 1e-3 * largest
            bad = {}
            for n in ref:
                strict = W.leaf_errors(got[n], ref[n], 1e-5, 1e-4)
                if strict and W.leaf_errors(got[n], ref[n], u_tol, 0.0):
                    bad[n] = strict
            if bad:
                raise AssertionError(f"64 fixture {fid} vs rpst's {step}: "
                                     f"{dict(list(bad.items())[:3])}")
            worst = max(worst, max(float(np.abs(
                got[n].get("full", got[n].get("pick")) - ref[n].get(
                    "full", ref[n].get("pick"))).max(initial=0.0))
                for n in ref) / largest)
        log("64 slice 8c train", f"{fid} 32px b4 SGD(1.0) on {{spatial: 2}} "
            f"vs rpst's one device / GSPMD: loss {loss:.7g} (rpst "
            f"{float(fx[f'{fid}/one/loss']):.7g} / "
            f"{float(fx[f'{fid}/d2s2/loss']):.7g}), worst update element "
            f"{worst:.3g} of the largest update off; ranks bit-equal")


def _slice8c_train_check(res, dev, name_power, whole=None):
    """Phase 64: the standard layout trained row-sharded by phase 63's two
    ranks on the one card over gloo (``_train_64_rank``), rpst's GSPMD
    step made explicit. The fixture's point against rpst
    (``_fx_64_check``); sanet (configs/train_static_sanet.yaml, 512px b1,
    float32 and bfloat16), the flagship's standard layout (512px b2) and
    TRAIN_64 (256px b2) against one device's step on the card: the loss
    at rtol 1e-4, the gradients within ``TRAIN_64_GRAD_REL`` of the
    largest (the flagship by phase 9's rule; sanet bfloat16's loss and
    gradients within 3x their own bfloat16 distance from float32 where
    that is more), exactly 6 / 6 /
    6 B6b-d on each rank in sanet's steps (float32 kernels: the one-device
    transform runs float32 as rpst's, in bfloat16 too) and none elsewhere;
    then the row-share B6b-d kernels (``_b6bd_shard``) and train_torch.py
    on {spatial: 2, model: 2} (4 ranks on the one card, 2 steps of the
    flagship yaml's standard layout); ``whole``: phase 23's B6 numbers at
    the whole image's shape. Returns (the row-share B6b-d launches over
    both ranks, their kernels JSON numbers)."""
    log("time", f"phase 64 ranks {float(res[0]['64/rank_s']):.1f}s (in "
        "phase 63's processes)")
    _fx_64_check(res)
    keys = (["sanet_float32", "flagship", "sanet_bfloat16"]
            + [_worker().family_id(n, o) for n, o in TRAIN_64])
    launches = [0, 0, 0]
    for i, key in enumerate(keys):
        ref = res[i % 2]  # the rank that took the one-device step
        counts = [res[r][f"64/{key}/launches"].tolist() for r in range(2)]
        want = [6, 6, 6, 0] if key.startswith("sanet") else [0, 0, 0, 0]
        if counts != [want, want]:
            raise AssertionError(f"64 {key}: B6b/c/d (bf16 B6b) launches a "
                                 f"rank {counts}, want {want}")
        if key.startswith("sanet"):
            launches = [a + b + c for a, b, c in
                        zip(launches, counts[0][:3], counts[1][:3])]
        loss, one = (float(ref[f"64/{key}/{k}"])
                     for k in ("total_loss", "one_loss"))
        if float(res[0][f"64/{key}/total_loss"]) != float(
                res[1][f"64/{key}/total_loss"]):
            raise AssertionError(f"64 {key}: the ranks' losses differ")
        loss_tol = 1e-4
        if key == "sanet_bfloat16":  # 3x its own bfloat16 distance
            f32_one = float(ref["64/sanet_float32/one_loss"])
            loss_tol = max(loss_tol, 3 * abs(one - f32_one) / abs(f32_one))
        if abs(loss - one) > loss_tol * abs(one):
            raise AssertionError(f"64 {key}: loss {loss} vs one device {one}"
                                 f" (rtol {loss_tol:.3g})")
        rel, p9 = ref[f"64/{key}/grad_err"].tolist()
        if key == "flagship":
            ok, rule = p9 <= 1.0, "phase 9's rule"
        elif key == "sanet_bfloat16":
            own = float(ref[f"64/{key}/own"])
            limit = max(TRAIN_64_GRAD_REL, 3 * own)
            ok, rule = rel <= limit, (f"limit {limit:.3g}: 3x its own "
                                      f"bf16 distance {own:.3g}")
        else:
            ok, rule = rel <= TRAIN_64_GRAD_REL, f"limit {TRAIN_64_GRAD_REL}"
        if not ok:
            raise AssertionError(f"64 {key}: gradients {rel:.3g} of the "
                                 f"largest off one device's ({rule}; phase "
                                 f"9's measure {p9:.3g})")
        timing = ""
        if f"64/{key}/one_ms" in ref:
            timing = (f"; a second step {float(ref[f'64/{key}/step_ms']):.1f}"
                      f" ms on a rank (two ranks share the card), "
                      f"{float(ref[f'64/{key}/one_ms']):.1f} ms on one "
                      f"device ({name_power})")
        log("64 slice 8c train", f"{key} on {{spatial: 2}} vs one device: "
            f"loss {loss:.7g} / {one:.7g}, gradients {rel:.3g} of the "
            f"largest off ({rule}; phase 9's measure {p9:.3g}), B6b/c/d "
            f"launches a rank {counts[0][:3]} (bf16 B6b {counts[0][3]}); "
            f"{float(res[0][f'64/{key}/rank_s']):.1f}s on rank 0{timing}")
    b6 = _b6bd_shard(dev, name_power, whole)
    _model_spatial_cli()
    return launches, b6


def _model_spatial_cli():
    """Phase 64's driver run: train_torch.py with mesh_shape {spatial: 2,
    model: 2} on the flagship yaml in the standard layout (attention se,
    use_mask false), 256px b2 float32, 2 steps, its four ranks started by
    train_torch.py over gloo on the one card: the rows route logged with
    the model axis, 2 loss lines and one checkpoint from rank 0."""
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_corpus.py"),
                        str(tmp / "corpus"), "--n", "4", "--size",
                        str(TRAIN_64_SIZE)],
                       check=True, capture_output=True, timeout=300)
        out = tmp / "rows"
        t0 = time.perf_counter()
        text = _driver_run("train_torch.py", [
            "--config", str(FLAGSHIP_YAML), "--device", "cuda", "--set",
            f"content_dir={tmp / 'corpus' / 'content'}",
            f"style_dir={tmp / 'corpus' / 'style'}", "test_dir=", "vgg=",
            f"output={out}", "use_mask=false", "exec_strategy=standard",
            "compute_dtype=float32", "batch_size=2",
            f"img_size={TRAIN_64_SIZE}", "mesh_shape={spatial: 2, model: 2}",
            "max_iter=3", "log_iter=1", "snapshot_save_iter=100",
            "num_workers=0"])
        wall = time.perf_counter() - t0
        lines = [json.loads(ln) for ln in
                 (out / "logs" / "metrics.jsonl").read_text().splitlines()]
        if [ln["step"] for ln in lines] != [1, 2] or any(
                ln["skipped"] or not np.isfinite(ln["total_loss"])
                for ln in lines):
            raise AssertionError(f"64 model x spatial metrics: {lines}")
        if _dump_names(out / "checkpoints") != ["2"]:
            raise AssertionError(
                f"64 checkpoints {_dump_names(out / 'checkpoints')}")
        if "row-sharded standard layout" not in text or \
                "channel tensor parallel on the model axis" not in text:
            raise AssertionError(f"64 route not logged:\n{text[-3000:]}")
        log("64 slice 8c train", f"train_torch.py {FLAGSHIP_YAML.name} "
            f"(standard, attention se, use_mask false) on mesh_shape "
            f"{{spatial: 2, model: 2}}, {TRAIN_64_SIZE}px b2 float32, 4 "
            f"ranks over "
            f"gloo on the one card: 2 steps in {wall:.1f}s wall (start and "
            f"loading included), total_loss "
            f"{[round(ln['total_loss'], 4) for ln in lines]}; one checkpoint "
            f"(2) from rank 0")


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--spatial-rank":
        spatial_rank(*sys.argv[2:])
    elif len(sys.argv) == 5 and sys.argv[1] == "--slice8b-rank":
        slice8b_rank(*sys.argv[2:])
    elif len(sys.argv) == 5 and sys.argv[1] == "--slice8c-rank":
        slice8c_rank(*sys.argv[2:])
    else:
        main()
