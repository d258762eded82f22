"""The target cache of the port (``rpst_torch.train.target_cache``,
``nn.vgg_folded.perceptual_rp_losses_folded_pretargets``,
``ModelBundle.loss(targets=...)``, ``train_torch.py`` with
``target_cache``) on the CPU.

The cached step's loss parts and gradients are held to rpst's (the
pretargets route, ``tests/fixtures/torch_port_target_cache.npz``,
``tools/make_torch_port_fixture.py --target-cache``, on the train
fixture's full-width flagship at 64px b2) and to the port's own
recomputed step at float tolerance (loss rtol 1e-5; gradients rtol 1e-4,
atol 1e-6 x max: the targets enter the same way, only their summation
order differs). Also: rpst's LRU slot mechanics, its whole-batch hit rule,
both refusals, and the driver with a corpus revisited within the run."""

import importlib.util
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from rpst.train.target_cache import DeviceTargetCache as JaxCache
from rpst_torch.bridge import (flax_tree_from_npz, from_flax_params,
                               vgg_from_flax, vgg_weights_from_seed)
from rpst_torch.config import load_config
from rpst_torch.metrics import logger
from rpst_torch.models import build_model
from rpst_torch.nn.vgg import VGG19Encoder
from rpst_torch.nn.vgg_folded import vgg_perceptual_stats
from rpst_torch.train.step import (check_target_cache, create_train_state,
                                   train_step)
from rpst_torch.train.target_cache import STAGE_CHANNELS, DeviceTargetCache
from test_torch_sel_multi_adain import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
FLAGSHIP = dict(network="multi_adain", enc_stack_way="constant",
                rp_blocks=5, hidden_dim=32)
LOSS_KEYS = ("content_loss", "style_loss", "total_loss")


def _load(name):
    with np.load(FIXTURES / name) as npz:
        return flax_tree_from_npz(npz), {k: npz[k] for k in npz.files
                                         if "/" not in k}


@pytest.fixture(scope="module")
def train_fx():
    tree, fx = _load("torch_port_train.npz")
    tree.pop("grads")
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]))))
    return tree, fx, vgg


def _bundle(tree, fx, **over):
    bundle = build_model(load_config(dict(
        FLAGSHIP, img_size=fx["content"].shape[1], exec_strategy="folded",
        **over)))
    bundle.load_state_dict(from_flax_params(tree))
    return bundle


def _loss_and_grads(bundle, vgg, c, s, targets=None):
    bundle.model.zero_grad(set_to_none=True)
    total, parts = bundle.loss(vgg, c, s, targets=targets)
    total.backward()
    return ({k: float(parts[k].detach()) for k in LOSS_KEYS},
            {n: p.grad.clone() for n, p in bundle.model.named_parameters()})


def test_targets_are_rpst_and_the_cached_step_is_the_recomputed_one(
        train_fx):
    tree, fx, vgg = train_fx
    c, s = (torch.from_numpy(fx[k]) for k in ("content", "style"))
    n = c.shape[0]
    bundle = _bundle(tree, fx)
    cache = DeviceTargetCache(c.shape[1], torch.float32, content_slots=4,
                              style_slots=4)
    miss = cache.targets_for_batch(vgg, s, c, [10, 11], [20, 21])
    hit = cache.targets_for_batch(vgg, s, c, [11, 10], [21, 20])
    assert cache.stats() == {"hit_steps": 1, "miss_steps": 1,
                             "content_cached": 2, "style_cached": 2}
    _, ref = _load("torch_port_target_cache.npz")
    rgrads = from_flax_params(_load("torch_port_target_cache.npz")[0]
                              ["grads"])
    for i, (m, sd) in enumerate(miss[0]):
        np.testing.assert_allclose(m.numpy(), ref[f"t_mean_{i}"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(sd.numpy(), ref[f"t_std_{i}"], rtol=1e-4,
                                   atol=1e-5)
        # a hit gathers the keys' rows: the batch came back in another order
        np.testing.assert_array_equal(hit[0][i][0].numpy(),
                                      m.numpy()[::-1])
    np.testing.assert_allclose(miss[1].numpy(), ref["t_relu4"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(hit[1].numpy(), miss[1].numpy()[::-1])
    cached, g_cached = _loss_and_grads(bundle, vgg, c, s, miss)
    recomputed, g_plain = _loss_and_grads(bundle, vgg, c, s)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(cached[k], float(ref[k]), rtol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(cached[k], recomputed[k], rtol=1e-5,
                                   err_msg=k)
    for name, g in g_cached.items():
        torch.testing.assert_close(g, rgrads[name], rtol=5e-3,
                                   atol=1e-4 * float(rgrads[name].abs().max()),
                                   msg=name)
        torch.testing.assert_close(g, g_plain[name], rtol=1e-4,
                                   atol=1e-6 * float(g_plain[name].abs().max()),
                                   msg=name)
    assert n == 2


def test_lru_slots_follow_rpst():
    """The same key sequence through rpst's host bookkeeping and the
    port's gives the same slots, evictions included."""
    ours = DeviceTargetCache(8, torch.float32, content_slots=3,
                             style_slots=2)
    keys = [1, 2, 3, 1, 4, 5, 3, 1, 6]
    for cap, lru_ours in ((3, ours._c_map), (2, ours._s_map)):
        lru_ref = type(lru_ours)()
        for k in keys:
            a = DeviceTargetCache._assign(lru_ours, k, cap)
            b = JaxCache._assign(lru_ref, k, cap)
            assert a == b, (k, cap)
        assert list(lru_ours.items()) == list(lru_ref.items())
    assert DeviceTargetCache._touch(ours._c_map, 1) == \
        ours._c_map[1] and list(ours._c_map)[-1] == 1


def test_whole_batch_hit_rule_and_storage():
    """A single content miss recomputes the whole batch (rpst's rule,
    ``target_cache.py:111-112``); the stored values are what the loss
    consumed, in its types; ``nbytes`` counts the slots."""
    rng = np.random.default_rng(0)
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(1)))
    c, s = (torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32))
            for _ in range(2))
    cache = DeviceTargetCache(16, torch.bfloat16, content_slots=2,
                              style_slots=3)
    assert cache.nbytes() == 2 * 2 * 2 * 512 * 2 + 2 * 3 * 4 * sum(
        STAGE_CHANNELS)
    t_stats, t_relu4 = cache.targets_for_batch(vgg, s, c, ["a", "b"],
                                               [0, 1])
    assert t_relu4.dtype == torch.bfloat16 and t_stats[0][0].dtype == \
        torch.float32
    want_stats, want_relu4 = vgg_perceptual_stats(vgg, torch.cat([s, c]),
                                                  torch.bfloat16)
    torch.testing.assert_close(t_relu4, want_relu4[2:], rtol=0, atol=0)
    torch.testing.assert_close(cache._c_cache[:2], t_relu4, rtol=0, atol=0)
    # style keys hit, one content key is new: a miss for the whole batch
    cache.targets_for_batch(vgg, s, c, ["a", "b"], [1, 2])
    assert cache.stats() == {"hit_steps": 0, "miss_steps": 2,
                             "content_cached": 2, "style_cached": 2}
    assert list(cache._c_map) == [1, 2]  # key 0 evicted, its slot reused
    cache.targets_for_batch(vgg, s, c, ["b", "a"], [2, 1])
    assert cache.stats()["hit_steps"] == 1


def test_refusals_follow_rpst(train_fx):
    tree, fx, vgg = train_fx
    with pytest.raises(ValueError, match="grad_accum"):
        check_target_cache(load_config(dict(grad_accum=2)))
    with pytest.raises(ValueError, match="perceptual-loss"):
        check_target_cache(load_config({}), with_labels=True)
    check_target_cache(load_config({}))
    bundle = _bundle(tree, fx, grad_accum=2)
    state = create_train_state(bundle)
    c, s = (torch.from_numpy(fx[k]) for k in ("content", "style"))
    targets = DeviceTargetCache(c.shape[1], torch.float32, 2, 2) \
        .targets_for_batch(vgg, s, c, [0, 1], [0, 1])
    with pytest.raises(ValueError, match="grad_accum"):
        train_step(state, vgg, c, s, targets=targets)
    standard = build_model(load_config(dict(FLAGSHIP, img_size=64)))
    with pytest.raises(ValueError, match="folded"):
        standard.loss(vgg, c, s, targets=targets)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_driver_trains_with_the_cache(tmp_path):
    """train_torch.py with ``target_cache`` on a corpus of two images a
    side at batch 2: every step after the first revisits both, so 1 miss
    then hits; the log has the slot line, rpst's ``tcache_hit_steps`` and
    the superseded ``train_q8_targets``."""
    rng = np.random.default_rng(0)
    for sub in ("content", "style"):
        (tmp_path / sub).mkdir()
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (36, 36, 3), np.uint8),
                            "RGB").save(tmp_path / sub / f"{i}.png")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(json.dumps(dict(
        network="multi_adain", rp_blocks=3, hidden_dim=8, img_size=32,
        batch_size=2, num_workers=1, exec_strategy="folded", max_iter=5,
        snapshot_save_iter=10, target_cache=4, target_cache_style_slots=4,
        train_q8_targets=True,
        content_dir=str(tmp_path / "content"),
        style_dir=str(tmp_path / "style"), output=str(tmp_path / "out"))))
    spec = importlib.util.spec_from_file_location("train_torch",
                                                  REPO / "train_torch.py")
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    handler = _Lines()
    logger.addHandler(handler)
    try:
        driver.main(["--config", str(cfg), "--device", "cpu"])
    finally:
        logger.removeHandler(handler)
    text = "\n".join(handler.lines)
    assert "target_cache: 4 content slots (0 MiB of device memory)" in text
    assert "train_q8_targets superseded by target_cache" in text
    assert "tcache_hit_steps 3/4" in text
    assert ("target_cache stats: {'hit_steps': 3, 'miss_steps': 1, "
            "'content_cached': 2, 'style_cached': 2}") in text
    lines = [json.loads(ln) for ln in (tmp_path / "out" / "logs"
                                       / "metrics.jsonl").read_text()
             .splitlines()]
    assert [ln["step"] for ln in lines] == [1, 2, 3, 4]
    assert all(np.isfinite(ln["total_loss"]) for ln in lines)
