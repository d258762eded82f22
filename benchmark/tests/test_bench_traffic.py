"""The inputs, orders and weights a seed makes are the same on every call
and differ between seeds."""

import numpy as np
import torch

from harness import inputs, train

SEEDS = (0, 2 ** 31 + 5, 9_000_000_001)


def test_image_pool_is_the_seeds_and_in_range():
    for seed in SEEDS:
        a = inputs.image_pool(3, 32, seed, inputs.CONTENT, "cpu")
        b = inputs.image_pool(3, 32, seed, inputs.CONTENT, "cpu")
        assert a.shape == (3, 32, 32, 3) and a.dtype == np.float32
        assert np.array_equal(a, b)
        assert 0.0 <= a.min() and a.max() <= 1.0
    other = inputs.image_pool(3, 32, SEEDS[0] + 1, inputs.CONTENT, "cpu")
    assert not np.array_equal(other, inputs.image_pool(
        3, 32, SEEDS[0], inputs.CONTENT, "cpu"))


def test_images_have_structure_beyond_pixel_noise():
    """Neighbouring pixels correlate (structure at coarse scales)."""
    a = inputs.image_pool(4, 64, 7, inputs.STYLE, "cpu")
    x = a - a.mean(axis=(1, 2), keepdims=True)
    corr = (x[:, 1:] * x[:, :-1]).mean() / (x ** 2).mean()
    assert corr > 0.5


def test_style_draws_and_pools_by_purpose():
    for seed in SEEDS:
        d = inputs.style_draws(seed, 1000, 16)
        assert np.array_equal(d, inputs.style_draws(seed, 1000, 16))
        assert d.min() >= 0 and d.max() < 16 and len(set(d)) == 16
    c = inputs.image_pool(2, 16, 3, inputs.CONTENT, "cpu")
    s = inputs.image_pool(2, 16, 3, inputs.STYLE, "cpu")
    assert not np.array_equal(c, s)


def test_training_feed_is_the_seeds_and_rows_differ():
    tr = {"batch_size": 4, "content_pool": 16, "style_pool": 4}
    c, s = inputs.pools(tr, 16, 11, "cpu")
    feed = train._feeder(tr, c, s, 11, "cpu")
    again = train._feeder(tr, c, s, 11, "cpu")
    rows = [feed(k)[0] for k in range(3)]
    for k in range(3):
        for x, y in zip(feed(k), again(k)):
            assert torch.equal(x, y)
    flat = torch.cat(rows).reshape(12, -1)
    assert len({tuple(r[:8].tolist()) for r in flat}) == 12


def test_seeded_weights_rules():
    shapes = [("a.weight", (8, 4, 3, 3)), ("a.bias", (8,)),
              ("p.weight", (8, 8, 1, 1)), ("p.bias", (8,)),
              ("l.weight", (2, 8)), ("l.bias", (2,))]
    w = inputs.seeded_weights(shapes, "he_3x3", 5, inputs.MODEL, "cpu")
    again = inputs.seeded_weights(shapes, "he_3x3", 5, inputs.MODEL, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert w["a.weight"].abs().max() <= (6 / 36) ** 0.5
    assert w["a.weight"].abs().max() > 36 ** -0.5     # He, not default
    assert w["p.weight"].abs().max() <= 8 ** -0.5     # 1x1: default
    assert w["a.bias"].abs().max() <= 36 ** -0.5
    assert torch.count_nonzero(w["l.bias"]) == 0
    v = inputs.seeded_weights(shapes, "he", 5, inputs.VGG, "cpu")
    assert v["a.bias"].abs().max() <= 0.01
    assert not torch.equal(v["a.weight"], w["a.weight"])
