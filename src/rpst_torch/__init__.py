"""rpst_torch: the PyTorch/CUDA port of rpst for NVIDIA Hopper (H100).

The JAX package ``rpst`` is the reference; this package computes the same
functions with PyTorch for plain tensor code and hand-written CUDA kernels
where rpst has Pallas kernels. It imports ``torch`` and never ``jax``, and
nothing of rpst: it reads rpst's config files and checkpoints with loaders
of its own.

Layer map, entry points down to the device (the flagship ``multi_adain``
constant stack: folded inference and serving, and training on one device):

  serve_torch.py                 folder sweep / ``--daemon`` CLI
  train_torch.py                 training CLI (train.py's counterpart)
  rpst_torch.serving             resolve_mode, make_run_impl, DynamicBatcher,
                                 serve_daemon
  rpst_torch.train               step (TrainState, train_step, Adam + lr
                                 schedule), fault (non-finite skip, signal
                                 checkpoint), checkpoint, metrics
  rpst_torch.models              build_model -> ModelBundle.stylize / .loss,
                                 build_vgg
  rpst_torch.models.fast_path    stylize_multi_adain_folded (folded path,
                                 cached or live folded weights)
  rpst_torch.models.adain_rp     MultiScaleAdaINRP (standard path)
  rpst_torch.models.base         perceptual_rp_losses (standard loss)
  rpst_torch.nn.vgg[_folded]     frozen VGG19Encoder; folded-stage loss
  rpst_torch.nn.blocks           PadConv, Conv2dBlock, RPStack
  rpst_torch.ops.folded          fold/unfold, folded kernels, rings, AdaIN
  rpst_torch.ops.stats           calc_mean_std, AdaIN
  rpst_torch.ops.folded_conv     B1/B2/B3 wrappers (+ plain versions),
                                 FoldedConvAct (autograd)
  rpst_torch.kernels.build       nvcc build of csrc/*.cu, ctypes binding
  rpst_torch/csrc/folded_conv.cu      B1 CUDA kernel for sm_90a
  rpst_torch/csrc/folded_conv_bwd.cu  B2, B3 CUDA kernels for sm_90a
  rpst_torch/csrc/folded_mma.cuh      B1 / B2's tensor-core main loop
  rpst_torch/csrc/mma_common.cuh      cp.async, mma.sync, TF32 split helpers
  rpst_torch.bridge              flax params / reference .pth / VGG -> state_dict
  rpst_torch.config              load_config (rpst's YAML format)
  rpst_torch.data                load_image, to_u8 (PIL); training datasets,
                                 sampler, threaded loader
  rpst_torch.metrics             logger, save_image
"""
