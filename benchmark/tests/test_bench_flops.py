"""The FLOP counts stored in the configurations' files, counted again on
their references with ``FlopCounterMode`` on meta tensors at the cells'
shapes."""

import pytest

from harness import flops


@pytest.mark.parametrize("config", ["rp_adain_flagship", "sanet"])
def test_stored_flops_recount(manifest, config):
    conf = manifest.config(config)
    model_shapes, vgg_shapes = flops.shapes_of(conf)
    got = flops.count(manifest, config, model_shapes, vgg_shapes,
                      int(conf["settings"]["batch_size"]))
    assert got == conf["flops"]
    # a 3x3 conv of a 512px image, 2 per multiply-add, is in the count
    assert got["stylize_per_image"] > 2 * 9 * 512 * 512 * 3 * 32
    assert got["train_step_per_image"] > 2 * got["stylize_per_image"]
