"""One rank of the port's multi-device CPU tests (tests/test_torch_spatial.py,
tests/test_torch_dist.py): joins a gloo group through a file under the
test's directory, runs one suite of cases and saves what it computed to
``<out>/rank<r>.pt`` (a dict of tensors). Imports no JAX.

    python tests/torch_dist_worker.py SUITE RANK WORLD INIT_FILE OUT_DIR
"""

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

from rpst_torch.bridge import (flax_tree_from_npz,  # noqa: E402
                               from_flax_batch_stats, from_flax_params,
                               vgg_from_flax, vgg_weights_from_seed)
from rpst_torch.config import load_config  # noqa: E402
from rpst_torch.dist import (average_grads, make_mesh,  # noqa: E402
                             shard_batch)
from rpst_torch.models import build_model, build_vgg  # noqa: E402
from rpst_torch.models.fast_path_spatial import (loss_spatial,  # noqa: E402
                                                 stylize_spatial)
from rpst_torch.nn.blocks import init_torch_default  # noqa: E402
from rpst_torch.nn.vgg import VGG19Encoder  # noqa: E402
from rpst_torch.train.step import TrainState, train_step  # noqa: E402

FIX = REPO / "tests" / "fixtures"
FLAGSHIP = dict(network="multi_adain", enc_stack_way="constant",
                rp_blocks=5, hidden_dim=32, inception_num=0,
                attention="none")
# network -> (fixture, config): the points of tools/make_torch_port_fixture.py
# spatial_sources()
SPATIAL = {
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
MESHES = {"s2": {"spatial": 2}, "d2s2": {"data": 2, "spatial": 2},
          "s4": {"spatial": 4}}
# rpst's tests/test_train_matrix.py _TINY and FAMILIES
TINY = dict(img_size=32, rp_blocks=2, hidden_dim=8, inception_num=0,
            attention="none", ld_layer_num=3, stylized_layers=3, ndf=2,
            batch_size=4, lr=1e-3, lr_decay=0.0, compute_dtype="float32",
            max_seg_labels=8, vgg="")
FAMILIES = [
    ("adain", {}), ("multi_adain", {}),
    ("multi_adain", {"enc_stack_way": "deeper"}), ("sel_multi_adain", {}),
    ("ccam", {}), ("wct", {}), ("mrf", {}), ("spade", {}), ("src", {}),
    ("sanet", {}), ("dynamic_sanet", {}), ("ld_adain", {}),
    ("ld_adain2", {}), ("ld_adain3", {}), ("ld_adain4", {}),
    ("ld_adain5", {}), ("seg_adain", {}),
    # beyond rpst's matrix: mst (rpst's :161 matches or raises) and the
    # folded flagship on {data: 2} (the row-sharded route, one row share)
    ("mst", {}), ("multi_adain", {"exec_strategy": "folded"}),
]
# run in float64 too, where the sharded sums must meet one device's to
# float64 rounding: BatchNorms over the global batch (sel's SE bottleneck,
# spade's param-free batch norm, whose float32 gradients at these widths sit
# ~1e-3 of their max apart in any two summation orders) and the cross
# entropy's global sums
# the {model: 2} suite's networks: FAMILIES and the folded forms of the
# flagship's variants (the SE bottleneck's convs and the CCAM residuals on
# the folded path, column parallel beside B1-B3)
TP_FAMILIES = FAMILIES + [("sel_multi_adain", {"exec_strategy": "folded"}),
                          ("ccam", {"exec_strategy": "folded"})]
F64_FAMILIES = [("sel_multi_adain", {}), ("spade", {"spade_norm": "batch"}),
                ("seg_adain", {})]


# the SANets' transforms run in float32 whatever the model's type, as
# rpst's flax modules do: no float64 step
F32_ONLY = ("sanet", "dynamic_sanet")


def family_id(net, over):
    return net + "".join(f"-{k}={v}" for k, v in over.items())


def fixture_bundle(network, dtype=torch.float32):
    name, cfg = SPATIAL[network]
    with np.load(FIX / name) as npz:
        tree = flax_tree_from_npz(npz)
        fx = {k: npz[k] for k in ("content", "style", "vgg_seed")}
    bundle = build_model(load_config(dict(
        cfg, img_size=fx["content"].shape[1], exec_strategy="folded")))
    sd = from_flax_params({k: v for k, v in tree.items()
                           if k in ("ms", "rp_shared_encoder", "rp_decoder",
                                    "attention_block")
                           or k.startswith("ccam_")})
    sd.update(from_flax_batch_stats(tree.get("batch_stats", {})))
    bundle.load_state_dict(sd)
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        int(fx["vgg_seed"]))))
    c, s = (torch.from_numpy(fx[k]) for k in ("content", "style"))
    if dtype == torch.float64:
        bundle.model.double()
        bundle.folded_dtype = lambda: torch.float64
        vgg.double()
        c, s = c.double(), s.double()
    bundle.model.train()
    return bundle, vgg, c, s


def grad_corner(g):
    """What tools/make_torch_port_fixture.py grad_corner keeps, in the
    port's layout: vectors whole, the [:8, :8] corner of a kernel (O, I)
    or a Linear weight (out, in), which ``bridge.from_flax_params`` makes
    of the flax corner."""
    return g[:8, :8].contiguous() if g.ndim >= 2 else g


def suite_spatial(rank, out):
    for network in SPATIAL:
        for mname, shape in MESHES.items():
            if mname == "s4" and network != "multi_adain":
                continue
            mesh = make_mesh(shape, torch.device("cpu"), subset=True)
            if not mesh.active:
                continue
            key = f"{network}/{mname}"
            bundle, vgg, c, s = fixture_bundle(network)
            c_l = shard_batch(c, mesh, spatial=True)
            s_l = shard_batch(s, mesh, spatial=True)
            out[f"{key}/out"] = stylize_spatial(bundle, c_l, s_l, mesh)
            for dt, sfx in ((torch.float32, ""), (torch.float64, "_f64")):
                if dt == torch.float64 and mname == "s4":
                    continue
                bundle, vgg, c, s = fixture_bundle(network, dt)
                c_l = shard_batch(c, mesh, spatial=True)
                s_l = shard_batch(s, mesh, spatial=True)
                total, parts = loss_spatial(bundle, vgg, c_l, s_l, mesh)
                total.backward()
                params = [p for p in bundle.model.parameters()
                          if p.requires_grad]
                average_grads(params, mesh.reduce_axes())
                for k in ("content_loss", "style_loss", "total_loss"):
                    out[f"{key}/{k}{sfx}"] = parts[k].detach()
                for n, p in bundle.model.named_parameters():
                    out[f"{key}/grads{sfx}/{n}"] = grad_corner(p.grad)
                if sfx == "":
                    for n, b in bundle.model.named_buffers():
                        out[f"{key}/buffers/{n}"] = b.clone()
    # two Adam steps of the flagship through train_step on {data 2, spatial 2}
    mesh = make_mesh(MESHES["d2s2"], torch.device("cpu"))
    bundle, vgg, c, s = fixture_bundle("multi_adain")
    from rpst_torch.train.step import create_train_state
    state = create_train_state(bundle, mesh=mesh)
    c_l = shard_batch(c, mesh, spatial=True)
    s_l = shard_batch(s, mesh, spatial=True)
    losses = [train_step(state, vgg, c_l, s_l)["total_loss"]
              for _ in range(2)]
    out["train_step/losses"] = torch.stack(losses)


def dp_case(net, over, mesh=None, remat=False, accum=1, f64=False):
    """(bundle, vgg, content, style, label) of a FAMILIES entry, its
    weights from one seed, its images from numpy's; on ``mesh`` the
    rank's batch share; ``f64``: the model, VGG and images in float64."""
    cfg = load_config(dict(TINY, network=net, remat=remat, grad_accum=accum,
                           **over))
    bundle = build_model(cfg)
    init_torch_default(bundle.model, 0)
    vgg, _ = build_vgg(cfg)
    gen = np.random.default_rng(0)
    c = gen.random((4, 32, 32, 3), dtype=np.float32)
    s = gen.random((4, 32, 32, 3), dtype=np.float32)
    label = (gen.integers(-1, cfg.class_num, (4, 32, 32)).astype(np.int64)
             if net == "seg_adain" else None)
    c, s = torch.from_numpy(c), torch.from_numpy(s)
    if f64:
        bundle.model.double()
        bundle.folded_dtype = lambda: torch.float64
        vgg.double()
        c, s = c.double(), s.double()
    label = None if label is None else torch.from_numpy(label)
    if mesh is not None:
        c, s = shard_batch(c, mesh), shard_batch(s, mesh)
        if label is not None:
            label = shard_batch(label, mesh)
    if bundle.from_features:
        bundle.vgg = vgg
    return bundle, vgg, c, s, label


def sgd_state(bundle, mesh=None):
    """rpst's test_train_matrix optimizer: SGD(1.0), so that the update is
    the gradient itself."""
    bundle.model.train()
    params = [p for p in bundle.model.parameters()]
    return TrainState(step=0, bundle=bundle,
                      optimizer=torch.optim.SGD(params, lr=1.0),
                      generator=torch.Generator().manual_seed(0),
                      schedule=lambda count: 1.0, mesh=mesh)


def suite_dp(rank, out):
    mesh = make_mesh({"data": 2}, torch.device("cpu"))
    for net, over in FAMILIES:
        key = family_id(net, over)
        bundle, vgg, c, s, label = dp_case(net, over, mesh)
        parts = train_step(sgd_state(bundle, mesh), vgg, c, s,
                           content_label=label)
        out[f"{key}/total_loss"] = parts["total_loss"]
        for n, p in bundle.model.named_parameters():
            out[f"{key}/params/{n}"] = p.detach().clone()
        for n, b in bundle.model.named_buffers():
            out[f"{key}/buffers/{n}"] = b.clone()
    for net, over in F64_FAMILIES:
        key = f"{family_id(net, over)}/f64"
        bundle, vgg, c, s, label = dp_case(net, over, mesh, f64=True)
        parts = train_step(sgd_state(bundle, mesh), vgg, c, s,
                           content_label=label)
        out[f"{key}/total_loss"] = parts["total_loss"]
        for n, p in bundle.model.named_parameters():
            out[f"{key}/params/{n}"] = p.detach().clone()
        for n, b in bundle.model.named_buffers():
            out[f"{key}/buffers/{n}"] = b.clone()
    # grad_accum and remat on both routes
    for net, over in (("sel_multi_adain", {}),
                      ("multi_adain", {"exec_strategy": "folded"})):
        for remat, accum in ((True, 1), (False, 2)):
            key = f"{family_id(net, over)}/remat={remat}/accum={accum}"
            bundle, vgg, c, s, label = dp_case(net, over, mesh, remat, accum)
            parts = train_step(sgd_state(bundle, mesh), vgg, c, s)
            out[f"{key}/total_loss"] = parts["total_loss"]
            for n, p in bundle.model.named_parameters():
                out[f"{key}/params/{n}"] = p.detach().clone()


# rpst's stylize_sanet_spatial cases of tests/fixtures/torch_port_slice8b.npz
# (tools/make_torch_port_fixture.py --slice8b): network, ada_module, dtype
SANET_CASES = {"sanet_f32": ("sanet", "aea", torch.float32),
               "sanet_bf16": ("sanet", "aea", torch.bfloat16),
               "dynamic_sanet_aea": ("dynamic_sanet", "aea", torch.float32),
               "dynamic_sanet_relu": ("dynamic_sanet", "relu",
                                      torch.float32)}


def sanet_bundle(case, size, seed=0, vgg_seed=1):
    """(bundle, content, style) of a SANET_CASES entry at ``size`` px,
    batch 1: weights from ``bridge``'s seeds, images from numpy's."""
    from rpst_torch.bridge import (dynamic_sanet_weights_from_seed,
                                   sanet_weights_from_seed)
    net, ada, dt = SANET_CASES[case]
    cfg = load_config(dict(network=net, ada_module=ada, img_size=size,
                           vgg="", adaptive_blockwise="never",
                           compute_dtype="bfloat16"
                           if dt == torch.bfloat16 else "float32"))
    bundle = build_model(cfg)
    tree = (sanet_weights_from_seed(seed) if net == "sanet"
            else dynamic_sanet_weights_from_seed(seed, size))
    bundle.load_state_dict(from_flax_params(tree))
    vgg = VGG19Encoder(num_stages=5)
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(vgg_seed, 5)))
    bundle.vgg = vgg
    gen = np.random.default_rng(seed)
    c = torch.from_numpy(gen.random((1, size, size, 3), dtype=np.float32))
    s = torch.from_numpy(gen.random((1, size, size, 3), dtype=np.float32))
    return bundle, c, s


def suite_sanet_spatial(rank, out):
    """rpst's row-sharded SANet serving on {spatial: 2}: each SANET_CASES
    entry's stylize at 64px, rows gathered."""
    from rpst_torch.dist.collectives import all_gather
    from rpst_torch.models.fast_path_spatial import stylize_sanet_spatial
    mesh = make_mesh({"spatial": 2}, torch.device("cpu"), subset=True)
    if not mesh.active:
        return
    for case in SANET_CASES:
        bundle, c, s = sanet_bundle(case, 64)
        y = stylize_sanet_spatial(bundle, shard_batch(c, mesh, True),
                                  shard_batch(s, mesh, True), mesh)
        out[f"{case}/out"] = torch.cat(all_gather(y, mesh.axis("spatial")),
                                       dim=1)


# rpst's tests/test_spatial_gspmd.py _TINY and FAMILIES: the slice-8c
# fixture's configs (tools/make_torch_port_fixture.py SLICE8C); the
# ``_l5`` points run LD v3 / v5 at five layers, where the coarse streams
# stop splitting evenly over four row shares
TINY_8C = dict(img_size=32, rp_blocks=2, hidden_dim=8, inception_num=0,
               attention="none", compute_dtype="float32", vgg="")
LD_NETS = ("ld_adain", "ld_adain2", "ld_adain3", "ld_adain4", "ld_adain5")
CASES_8C = {"adain": {}, "wct": {}, "mrf": {}, "spade": {},
            "seg_adain": {}, "src": {},
            **{n: {"network": n, "use_mask": False} for n in LD_NETS},
            "ld_adain3_l5": {"network": "ld_adain3", "use_mask": False,
                             "ld_layer_num": 5, "stylized_layers": 5},
            "ld_adain5_l5": {"network": "ld_adain5", "use_mask": False,
                             "ld_layer_num": 5, "stylized_layers": 5}}
# beyond rpst's GSPMD test (held to the port's one device): the
# multiscale family's standard layout (SE pools and bottlenecks, sort,
# shuffle, CCAM energies), src at 40px (its VGG pools reach odd shares and
# its stream runs whole), LD v1 / v2 on four shares
EXTRA_8C = {"multi_adain_se": {"network": "multi_adain", "attention": "se",
                               "sort": True, "shuffle": True},
            "sel_multi_adain": {"network": "sel_multi_adain"},
            "ccam": {"network": "ccam", "shuffle": False},
            "src_40": {"network": "src", "img_size": 40},
            "ld_adain_s4": {"network": "ld_adain", "use_mask": False},
            "ld_adain2_s4": {"network": "ld_adain2", "use_mask": False}}
# (case, mesh, compute dtype) of the slice-8c suite
RUNS_8C = ([(c, "s2", "float32") for c in list(CASES_8C)[:11]]
           + [("adain", "d2s2", "float32"),
              ("ld_adain3_l5", "s4", "float32"),
              ("ld_adain5_l5", "s4", "float32"),
              ("adain", "s2", "bfloat16"), ("ld_adain", "s2", "bfloat16"),
              ("multi_adain_se", "s2", "float32"),
              ("sel_multi_adain", "s2", "float32"),
              ("ccam", "s2", "float32"), ("src_40", "s2", "float32"),
              ("ld_adain_s4", "s4", "float32"),
              ("ld_adain2_s4", "s4", "float32")])
# the row-share primitives whose input gradients the suite also holds
GRAD_PRIMS = ("pad2d/reflect/1", "padconv/reflect/3", "padconv/zero/7",
              "maxpool_twice", "resize_pad", "instance_norm")
# (case, img_size, mesh) of the suite's height sweep: shares of 3 rows
# (odd: pools and pads gather), of 6 on four ranks and of 18 (9 after the
# first pool); src's VGG needs 10px on one device
SWEEP_8C = [(c, size, m) for c in list(CASES_8C)[:11] + list(EXTRA_8C)[:3]
            for size, m in ((6, "s2"), (12, "s4"), (36, "s2"))
            if not (c == "src" and size < 10)]


def images_8c(size=32, seed=0):
    """The slice-8c fixture's uint8 (2, size, size, 3) content and style
    (numpy's ``default_rng(seed)`` floats cut to uint8, as rpst's test
    makes them)."""
    rng = np.random.default_rng(seed)
    return tuple((rng.random((2, size, size, 3), np.float32) * 255
                  ).astype(np.uint8) for _ in range(2))


def case_8c(case, dtype="float32", device="cpu", size=None):
    """(bundle, content, style) of a CASES_8C / EXTRA_8C entry (at
    ``size`` px where given): the config, seeded weights (the families'
    ``bridge.weights_from_seed(cfg, 0)``, the multiscale ones
    ``flax_weights_from_seed``), src's VGG from ``vgg_weights_from_seed(1)``,
    the images of ``images_8c`` in [0, 1]."""
    from rpst_torch.bridge import flax_weights_from_seed, weights_from_seed
    over = dict(CASES_8C[case] if case in CASES_8C else EXTRA_8C[case])
    over.setdefault("network", case)
    if size is not None:
        over["img_size"] = size
    cfg = load_config(dict(TINY_8C, **over, compute_dtype=dtype))
    bundle = build_model(cfg, device)
    if case in CASES_8C or cfg.network in ("src", *LD_NETS):
        bundle.load_state_dict(from_flax_params(weights_from_seed(cfg, 0)))
    else:
        params, stats = flax_weights_from_seed(bundle.model, 0)
        sd = from_flax_params(params)
        sd.update(from_flax_batch_stats(stats))
        bundle.load_state_dict(sd)
    if bundle.from_features:
        vgg = VGG19Encoder()
        vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(1)))
        bundle.vgg = vgg.to(device)
    c, s = (torch.from_numpy(a).to(device).float() / 255
            for a in images_8c(cfg.img_size))
    return bundle, c, s


def suite_std_spatial(rank, out):
    """RUNS_8C through ``serving.make_mesh_run_impl`` (the entry the CLI
    and the daemon take), each batch gathered whole (``<case>/<mesh>/
    <dtype>``); the SWEEP_8C heights (``sweep/<case>/<size>/<mesh>``); and
    the row-share primitives on {spatial: 2} and {spatial: 4} against their
    one-device ops (``prim/...``: got, ref)."""
    from rpst_torch.serving import gather_batch, make_mesh_run_impl
    meshes = {m: make_mesh(MESHES[m], torch.device("cpu"), subset=True)
              for m in ("s2", "s4", "d2s2")}
    for case, mname, dtype in RUNS_8C:
        mesh = meshes[mname]
        if not mesh.active:
            continue
        bundle, c, s = case_8c(case, dtype)
        run = make_mesh_run_impl(bundle, "standard", mesh)
        y = run(shard_batch(c, mesh), shard_batch(s, mesh))
        out[f"{case}/{mname}/{dtype}"] = gather_batch(y, mesh)
    for case, size, mname in SWEEP_8C:
        mesh = meshes[mname]
        if not mesh.active:
            continue
        bundle, c, s = case_8c(case, size=size)
        run = make_mesh_run_impl(bundle, "standard", mesh)
        out[f"sweep/{case}/{size}/{mname}"] = run(c, s)
    for mname in ("s2", "s4"):
        if meshes[mname].active:
            row_share_prims(meshes[mname], out, f"prim/{mname}")


def row_share_prims(mesh, out, key):
    """Each row-share primitive on this rank's share of a seeded NCHW
    tensor, the share's rows gathered, beside the one-device op."""
    import torch.nn.functional as F
    from rpst_torch.dist.collectives import row_shares, whole_rows
    from rpst_torch.models.ld_adain import resize_nearest
    from rpst_torch.nn.blocks import PadConv, instance_norm, pad2d
    from rpst_torch.nn.rows import conv2d_rows, maxpool_ceil, spatial_mean
    from rpst_torch.ops.stats import calc_mean_std
    ax = mesh.axis("spatial")
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(2, 3, 24, 10, generator=gen)
    mine = x[:, :, ax.index * 24 // ax.size:(ax.index + 1) * 24 // ax.size]
    def seeded(conv):
        for p in (conv.weight, conv.bias):
            p.data = torch.randn(p.shape, generator=gen)
        return conv

    conv7 = seeded(torch.nn.Conv2d(3, 4, 7, padding=3))
    ops = {f"pad2d/{m}/{p}": (lambda v, m=m, p=p: pad2d(v, p, m))
           for m in ("reflect", "replicate", "zero") for p in (1, 2)}
    for m in ("reflect", "replicate", "zero"):
        for ks in (3, 7):
            pc = PadConv(3, 4, ks, ks // 2, m)
            seeded(pc.Conv_0)
            ops[f"padconv/{m}/{ks}"] = pc
    ops.update({
        "conv2d_rows": lambda v: conv2d_rows(conv7, v),
        "instance_norm": instance_norm,
        "maxpool_ceil": maxpool_ceil,
        "maxpool_twice": lambda v: maxpool_ceil(maxpool_ceil(v)),
        "resize_up": lambda v: resize_nearest(
            maxpool_ceil(v), v.shape[2], v.shape[3], channels_last=False),
        "resize_pad": lambda v: resize_nearest(
            pad2d(maxpool_ceil(v), 1), v.shape[2], v.shape[3],
            channels_last=False)})
    # 2 rows a share on four: fewer than a 7x7 halo takes, run whole
    short = torch.randn(1, 3, 2 * ax.size, 6, generator=gen)
    for m in ("reflect", "zero"):
        ops[f"short/padconv/{m}/7"] = ops[f"padconv/{m}/7"]
    with torch.no_grad():
        for name, op in ops.items():
            v = short if name.startswith("short/") else x
            k = v.shape[2] // ax.size
            ref = op(v)
            with row_shares(ax):
                got = whole_rows(op(v[:, :, ax.index * k:(ax.index + 1) * k]),
                                 2, ax)
            out[f"{key}/{name}/got"], out[f"{key}/{name}/ref"] = got, ref
        for name, op in (("spatial_mean", spatial_mean),
                         ("calc_mean_std", lambda v: torch.cat(
                             calc_mean_std(v.permute(0, 2, 3, 1)), -1))):
            ref = op(x)
            with row_shares(ax):
                got = op(mine)
            out[f"{key}/{name}/got"], out[f"{key}/{name}/ref"] = got, ref
    # the gradients through the halo, the gather and the sums: each rank
    # seeds its copy of the loss over the gathered output divided by the
    # axis size (the loss-copy rule of dist.average_grads); the shares'
    # input gradients gathered are one device's
    for name in GRAD_PRIMS:
        op = ops[name]
        xr = x.clone().requires_grad_()
        y = op(xr)
        g = torch.randn(y.shape, generator=gen)
        (y * g).sum().backward()
        xs = mine.clone().requires_grad_()
        with row_shares(ax):
            ys = whole_rows(op(xs), 2, ax)
        ((ys * g).sum() / ax.size).backward()
        out[f"{key}/grad/{name}/ref"] = xr.grad
        out[f"{key}/grad/{name}/got"] = whole_rows(xs.grad, 2, ax)


def column_ops(mesh, out):
    """A conv and a folded conv + lrelu, whole and as this rank's column
    share (``dist.tp``): outputs, dx and the share's dW / db under one
    cotangent (``ops/<op>/<what>/{got,ref}``), and the folded shares
    concatenated without the sub-position interleave."""
    import copy
    from rpst_torch.dist import tp
    from rpst_torch.dist.collectives import all_gather
    from rpst_torch.ops.folded import fold, fold_bias, fold_conv_kernel
    from rpst_torch.ops.folded_conv import folded_conv_act
    ax = mesh.axis("model")
    gen = torch.Generator().manual_seed(0)
    part = slice(ax.index * 4, (ax.index + 1) * 4)
    conv = torch.nn.Conv2d(6, 8, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
        conv.bias.copy_(torch.randn(8, generator=gen))
    col = copy.deepcopy(conv)
    tp.shard_model(col, ax, min_channels=8)
    x = torch.randn(2, 6, 8, 8, generator=gen)
    gy = torch.randn(2, 8, 8, 8, generator=gen)
    for name, m in (("ref", conv), ("got", col)):
        xr = x.clone().requires_grad_()
        y = m(xr)
        (y * gy).sum().backward()
        dw, db = m.weight.grad, m.bias.grad
        if name == "ref":
            dw, db = dw[part], db[part]
        for k, v in (("y", y), ("dx", xr.grad), ("dw", dw), ("db", db)):
            out[f"ops/conv/{k}/{name}"] = v.detach()
    # folded: (1, 8, 8, 4) -> 4C = 16 in, 4 Co = 32 out, shares of 16
    x_f = fold(torch.randn(1, 8, 8, 4, generator=gen))
    kern = torch.randn(3, 3, 4, 8, generator=gen) * 0.2
    bias = torch.randn(8, generator=gen)
    gy = torch.randn(1, 4, 4, 32, generator=gen)
    fk, fb = (fold_conv_kernel(kern).requires_grad_(),
              fold_bias(bias).requires_grad_())
    xr = x_f.clone().requires_grad_()
    y = folded_conv_act(xr, fk, fb, 0.2)
    (y * gy).sum().backward()
    out["ops/folded/y/ref"] = y.detach()
    out["ops/folded/dx/ref"] = xr.grad
    out["ops/folded/dk/ref"] = fk.grad.reshape(3, 3, 16, 4, 8)[
        ..., part].reshape(3, 3, 16, 16)
    out["ops/folded/db/ref"] = fb.grad.reshape(4, 8)[:, part].reshape(16)
    fk_s = fold_conv_kernel(kern[..., part].contiguous()).requires_grad_()
    fb_s = fold_bias(bias[part]).requires_grad_()
    fk_s.tp_column = ax
    xg = x_f.clone().requires_grad_()
    y = tp.folded_column(folded_conv_act)(xg, fk_s, fb_s, 0.2)
    (y * gy).sum().backward()
    out["ops/folded/y/got"] = y.detach()
    out["ops/folded/dx/got"] = xg.grad
    out["ops/folded/dk/got"] = fk_s.grad
    out["ops/folded/db/got"] = fb_s.grad
    with torch.no_grad():
        share = folded_conv_act(x_f, fk_s, fb_s, 0.2)
        out["ops/folded/concat"] = torch.cat(all_gather(share, ax), dim=-1)


def suite_tp(rank, out):
    """Every TP_FAMILIES entry's SGD(1.0) step on {model: 2}
    (column-parallel layers, min_channels 8 so that the tiny widths shard),
    in float32 and, but for F32_ONLY, in float64 (the folded path too): the
    updated parameters and buffers in the one-device layout, and what the
    rank stores."""
    from rpst_torch.dist import tp
    mesh = make_mesh({"model": 2}, torch.device("cpu"), subset=True)
    if not mesh.active:
        return
    column_ops(mesh, out)
    cases = [(n, o, f64) for n, o in TP_FAMILIES for f64 in (False, True)
             if not (f64 and n in F32_ONLY)]
    for net, over, f64 in cases:
        key = family_id(net, over) + ("/f64" if f64 else "")
        bundle, vgg, c, s, label = dp_case(net, over, mesh, f64=f64)
        whole = tp.stored_numel(bundle.model)
        out[f"{key}/sharded"] = torch.tensor(tp.shard_model(
            bundle.model, mesh.axis("model"), min_channels=8))
        if bundle.folded_infer() and net == "sel_multi_adain":
            se = bundle.folded_extras(live=True)  # the SE convs' shares
            out[f"{key}/se_widths"] = torch.tensor([
                se[k].shape[-1] if tp.column_axis(se[k]) else 0
                for k in ("k1", "k2", "k3")])
        state = sgd_state(bundle, mesh)
        parts = train_step(state, vgg, c, s, content_label=label)
        out[f"{key}/total_loss"] = parts["total_loss"]
        out[f"{key}/stored"] = torch.tensor([tp.stored_numel(bundle.model),
                                             whole])
        for n, t in tp.full_state_dict(bundle.model).items():
            out[f"{key}/state/{n}"] = t.clone()


# rpst's tests/test_dist.py BASE at hidden 16 (tools/make_torch_port_fixture.py
# TP_BASE), its TP test's min_channels
TP_BASE = dict(network="multi_adain", enc_stack_way="constant", rp_blocks=3,
               hidden_dim=16, img_size=16, batch_size=8, lr=1e-3,
               lr_decay=0.0, vgg="")
TP_MIN_CHANNELS = 8


def tp_fixture_point():
    """(rpst's initial params as a flax tree, content, style, VGG seed) of
    the slice-8b fixture's TP point."""
    tree = {}
    with np.load(FIX / "torch_port_slice8b.npz") as npz:
        for k in npz.files:
            if k.startswith("tp/params0/"):
                node = tree
                *parents, leaf = k[len("tp/params0/"):].split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = npz[k]
        return tree, npz["tp/content"], npz["tp/style"], int(npz["vgg_seed"])


def tp_fixture_state(mesh):
    """(state, vgg, content, style) at the slice-8b fixture's TP point: the
    fixture's initial params, sharded over ``mesh``'s model axis, Adam as
    the driver builds it."""
    from rpst_torch.dist import tp
    from rpst_torch.train.step import create_train_state
    tree, c, s, vgg_seed = tp_fixture_point()
    bundle = build_model(load_config(TP_BASE))
    bundle.load_state_dict(from_flax_params(tree))
    if mesh is not None:
        tp.shard_model(bundle.model, mesh.axis("model"), TP_MIN_CHANNELS)
    vgg = VGG19Encoder()
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(vgg_seed)))
    state = create_train_state(bundle, mesh=mesh)
    c, s = torch.from_numpy(c), torch.from_numpy(s)
    if mesh is not None:
        c, s = shard_batch(c, mesh), shard_batch(s, mesh)
    return state, vgg, c, s


def suite_tp_fixture(rank, out):
    """One Adam step of rpst's TP test point on {data: 2, model: 2}: the
    loss, the updated state in the one-device layout, what each rank
    stores, and the checkpoint round trip (written full-shape, restored
    onto {model: 2} shares again)."""
    from rpst_torch.dist import tp
    from rpst_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    mesh = make_mesh({"data": 2, "model": 2}, torch.device("cpu"))
    state, vgg, c, s = tp_fixture_state(mesh)
    for n, p in state.model.named_parameters():
        out[f"share0/{n}"] = p.detach().clone()
    parts = train_step(state, vgg, c, s)
    out["total_loss"] = parts["total_loss"]
    for n, t in tp.full_state_dict(state.model).items():
        out[f"state/{n}"] = t.clone()
    for n, p in state.model.named_parameters():
        out[f"shape/{n}"] = torch.tensor(p.shape)
    opt = state.optimizer.state_dict()["state"]
    out["moments_numel"] = torch.tensor(sum(
        v.numel() for st in opt.values() for k, v in st.items()
        if k in ("exp_avg", "exp_avg_sq")))
    out["stored"] = torch.tensor(tp.stored_numel(state.model,
                                                 state.optimizer))
    root = Path(sys.argv[5]) / "ckpt"
    out["ckpt_root"] = torch.tensor(list(str(root).encode()),
                                    dtype=torch.uint8)
    path = save_checkpoint(root, state, write=rank == 0)
    dist.barrier()
    again, _, _, _ = tp_fixture_state(mesh)
    restore_checkpoint(path, again)
    full = tp.full_optimizer_state(again.optimizer)["state"]
    mine = state.optimizer.state_dict()["state"]
    for i, st in again.optimizer.state_dict()["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"restored_moment/{i}/{k}"] = (st[k] - mine[i][k]).abs().max()
            out[f"full_moment/{i}/{k}"] = full[i][k]
    for n, t in again.model.state_dict().items():
        out[f"restored/{n}"] = (t - state.model.state_dict()[n]).abs().max()
    out["restored_step"] = torch.tensor(again.step)


def suite_accum(rank, out):
    """sel_multi_adain's (BatchNorm) float64 SGD(1.0) step with grad_accum
    2 on {data: 2}: the updated parameters and running statistics."""
    mesh = make_mesh({"data": 2}, torch.device("cpu"))
    bundle, vgg, c, s, _ = dp_case("sel_multi_adain", {}, mesh, accum=2,
                                   f64=True)
    out["total_loss"] = train_step(sgd_state(bundle, mesh), vgg, c,
                                   s)["total_loss"]
    for n, t in bundle.model.state_dict().items():
        out[f"state/{n}"] = t.clone()


# ----------------------------------------------- slice 8c: training

# rpst's tests/test_train_matrix.py FAMILIES with spatial_ok: every
# network but mst (the slice-8c training fixture's cases)
TRAIN_8C = [(n, o) for n, o in FAMILIES
            if n != "mst" and o.get("exec_strategy") != "folded"]
TRAIN_MESHES_8C = {"s2": {"spatial": 2}, "d2s2": {"data": 2, "spatial": 2},
                   "s2m2": {"spatial": 2, "model": 2}}
# remat and grad_accum on the rows route ({data: 2, spatial: 2}, float64:
# a microbatch of one image puts float32 summation order past rpst's
# limits): the recompute under the same row shares, rpst's microbatches
# re-dealt over data with the rows (and seg_adain's labels) kept
TRAIN_OPTS_8C = [("sel_multi_adain", {"remat": True}),
                 ("sel_multi_adain", {"grad_accum": 2}),
                 ("seg_adain", {"grad_accum": 2})]
# the float64 runs: the networks whose float32 updates at these widths
# differ by more than rpst's limits between two summation orders (against
# the port's one device: spade, src; against rpst's: sel's BatchNorm, ccam,
# wct, LD v1 / v3 / v4), and seg_adain's cross-entropy sums over the
# shares; the SANets' transforms stay float32, as rpst's
TRAIN_F64_8C = [(n, {}) for n in ("spade", "src", "sel_multi_adain",
                                  "ccam", "wct", "seg_adain", "ld_adain",
                                  "ld_adain3", "ld_adain4")]
# a leaf above this many elements is kept as its sum, its norm, PROJECTIONS
# seeded random projections and PICKS seeded elements
# (tools/make_torch_port_fixture.py compresses rpst's the same way)
BIG_LEAF = 2048
PROJECTIONS = 2
PICKS = 256


def _leaf_draw(name, n):
    """(projection vectors (PROJECTIONS, n), picked indices) of a leaf,
    seeded by the CRC of its name (Python's ``hash`` differs between
    processes)."""
    import zlib
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return (rng.standard_normal((PROJECTIONS, n)),
            rng.choice(n, size=min(PICKS, n), replace=False))


def compress_leaf(name, after, before):
    """What is kept of a leaf after a step (``after``, with its value
    ``before`` it): {"full", "upd_max"} for a small leaf; for one above
    BIG_LEAF elements {"size", "sum", "abs_sum", "norm", "proj",
    "proj_abs", "r_l1", "pick", "upd_max"}, float64: its size, its sum, the
    sum of its absolute
    values, its norm, its projections on the seeded vectors r and those of
    its absolute values on |r|, the L1 norms of r, its values at the
    seeded indices, and its largest absolute update."""
    a = np.asarray(after, np.float64).reshape(-1)
    upd = float(np.abs(a - np.asarray(before, np.float64).reshape(-1)).max()
                ) if a.size else 0.0
    if a.size <= BIG_LEAF:
        return {"full": a, "upd_max": np.array(upd)}
    r, idx = _leaf_draw(name, a.size)
    return {"size": np.array(a.size), "sum": np.array(a.sum()),
            "abs_sum": np.array(np.abs(a).sum()),
            "norm": np.array(np.linalg.norm(a)), "proj": r @ a,
            "proj_abs": np.abs(r) @ np.abs(a),
            "r_l1": np.abs(r).sum(axis=1), "pick": a[idx],
            "upd_max": np.array(upd)}


def pack_leaves(leaves):
    """The compressed leaves of one step ({leaf: {part: array}}) as one
    float32 vector, leaves and parts in sorted order (the fixture's form:
    rpst's values are float32)."""
    return np.concatenate([np.asarray(leaves[n][p], np.float32).reshape(-1)
                           for n in sorted(leaves) for p in sorted(leaves[n])])


def unpack_leaves(flat, like):
    """``pack_leaves``' inverse, the layout read from ``like`` (the port's
    compressed step of the same network)."""
    out, i = {}, 0
    for n in sorted(like):
        out[n] = {}
        for p in sorted(like[n]):
            k = np.asarray(like[n][p]).size
            out[n][p] = np.asarray(flat[i:i + k], np.float64).reshape(
                np.shape(like[n][p]))
            i += k
    if i != len(flat):
        raise ValueError(f"packed step of {len(flat)} values, layout {i}")
    return out


def leaf_errors(got, ref, atol, rtol, noise=(), factor=2.0):
    """The ways a compressed leaf ``got`` exceeds an elementwise limit
    ``|got - ref| <= atol + rtol |ref|`` against ``ref`` (both from
    ``compress_leaf``), as a list of strings (empty: within). A full leaf
    is checked element by element; a big one at its picked elements, and
    its sum, norm and projections against the bounds the elementwise limit
    implies for them. ``noise``: pairs (a, b) of compressed readings of
    the same leaf; each statistic's bound adds ``factor`` times the larger
    of their largest distances in it (ROADMAP section C's float32-noise
    rule, per tensor: 2x the larger own float32 error on the CPU, 4x on
    the card)."""
    bad = []

    def over(what, d, bound):
        if noise:  # per leaf and statistic, as ROADMAP section C holds it
            bound = bound + factor * max(float(np.abs(np.asarray(a[what])
                                                 - np.asarray(b[what])).max(
                                                     initial=0.0))
                                    for a, b in noise)
        d, bound = np.abs(np.asarray(d)), np.asarray(bound)
        if np.any(d > bound):
            bad.append(f"{what}: {d.max():.3g} > {bound.min():.3g}")
    if "full" in ref:
        over("full", got["full"] - ref["full"],
             atol + rtol * np.abs(ref["full"]))
        return bad
    size = float(ref["size"])
    over("pick", got["pick"] - ref["pick"],
         atol + rtol * np.abs(ref["pick"]))
    over("sum", got["sum"] - ref["sum"], atol * size + rtol * ref["abs_sum"])
    over("norm", got["norm"] - ref["norm"],
         atol * np.sqrt(size) + rtol * ref["norm"])
    over("proj", got["proj"] - ref["proj"],
         atol * ref["r_l1"] + rtol * ref["proj_abs"])
    return bad


def train_case_8c(net, over, mesh=None, f64=False, device="cpu"):
    """(bundle, vgg, content, style, label) of a TRAIN_8C entry at rpst's
    ``_TINY`` (test_train_matrix.py:37-40): seeded weights (the families'
    ``bridge.weights_from_seed(cfg, 0)``, the multiscale ones
    ``flax_weights_from_seed``, the SANets' own draws), the VGG from
    ``vgg_weights_from_seed(1)``, the images and labels of rpst's
    ``_setup`` (numpy's ``default_rng(0)``); on ``mesh`` the rank's batch
    share and rows, the model's channel shares on a ``model`` axis
    (min_channels 8, so that the tiny widths shard); ``f64``: the model,
    VGG and images in float64; on ``device`` (a mesh's own otherwise)."""
    from rpst_torch.bridge import (dynamic_sanet_weights_from_seed,
                                   flax_weights_from_seed,
                                   sanet_weights_from_seed,
                                   weights_from_seed)
    from rpst_torch.dist import tp
    cfg = load_config(dict(TINY, network=net, **over))
    device = mesh.device if mesh is not None else torch.device(device)
    bundle = build_model(cfg, device)
    if net == "sanet":
        sd = from_flax_params(sanet_weights_from_seed(0))
    elif net == "dynamic_sanet":
        sd = from_flax_params(dynamic_sanet_weights_from_seed(
            0, cfg.img_size))
    elif net in ("multi_adain", "sel_multi_adain", "ccam"):
        params, stats = flax_weights_from_seed(bundle.model, 0)
        sd = from_flax_params(params)
        sd.update(from_flax_batch_stats(stats))
    else:
        sd = from_flax_params(weights_from_seed(cfg, 0))
    bundle.load_state_dict(sd)
    vgg = VGG19Encoder(num_stages=bundle.vgg_stages)
    vgg.load_state_dict(vgg_from_flax(vgg_weights_from_seed(
        1, bundle.vgg_stages)))
    vgg = vgg.to(device)
    gen = np.random.default_rng(0)
    img = cfg.img_size
    c = torch.from_numpy(gen.random((4, img, img, 3), np.float32))
    s = torch.from_numpy(gen.random((4, img, img, 3), np.float32))
    label = (torch.from_numpy(gen.integers(-1, cfg.class_num, (4, img, img))
                              .astype(np.int64))
             if net == "seg_adain" else None)
    if f64:
        bundle.model.double()
        vgg.double()
        c, s = c.double(), s.double()
    c, s = c.to(device), s.to(device)
    label = None if label is None else label.to(device)
    if mesh is not None:
        c, s = (shard_batch(t, mesh, spatial=True) for t in (c, s))
        if label is not None:
            label = shard_batch(label, mesh, spatial=True)
        if mesh.model > 1:
            tp.shard_model(bundle.model, mesh.axis("model"), min_channels=8)
    if bundle.from_features:
        bundle.vgg = vgg
    return bundle, vgg, c, s, label


def _stats_own_type(feat, eps=1e-5):
    """``ops.stats.calc_mean_std`` with its reductions in the features' own
    type (it casts them to float32, as rpst does), row shares included."""
    from rpst_torch.dist.collectives import row_axis, row_moments
    ax = row_axis(feat)
    if ax is None:
        mean = feat.mean(dim=(1, 2), keepdim=True)
        n = feat.shape[1] * feat.shape[2]
        var = ((feat - mean) ** 2).sum(dim=(1, 2), keepdim=True) / max(
            n - 1, 1)
    else:
        mean, var = row_moments(feat, (1, 2), ax, unbiased=True)
    return mean, torch.sqrt(var + eps)


def float64_stats():
    """The port's feature statistics in the features' type until the
    returned undo is called: a float64 step is then float64 throughout,
    and a row-sharded one meets one device's to float64 rounding (with
    them in float32 both read float32 sums in two orders)."""
    from rpst_torch.models import base
    from rpst_torch.ops import stats
    old = stats.calc_mean_std, base.calc_mean_std
    stats.calc_mean_std = base.calc_mean_std = _stats_own_type

    def undo():
        stats.calc_mean_std, base.calc_mean_std = old
    return undo


def train_step_8c(net, over, mesh=None, f64=False, device="cpu"):
    """One SGD(1.0) step of a TRAIN_8C entry (``f64``: in float64, the
    statistics too: ``float64_stats``): {"loss", "state/<name>/..."
    (the one-device layout, ``compress_leaf``), "digest" (the SHA-256 of
    every parameter's and buffer's bytes)}."""
    import hashlib
    from rpst_torch.dist import tp
    bundle, vgg, c, s, label = train_case_8c(net, over, mesh, f64,
                                             device=device)
    before = {n: t.clone() for n, t in tp.full_state_dict(
        bundle.model).items()}
    undo = float64_stats() if f64 else (lambda: None)
    try:
        parts = train_step(sgd_state(bundle, mesh), vgg, c, s,
                           content_label=label)
    finally:
        undo()
    out = {"loss": parts["total_loss"].detach().double()}
    full = tp.full_state_dict(bundle.model)
    h = hashlib.sha256()
    for n in sorted(full):
        t = full[n].detach().cpu().contiguous()
        h.update(t.numpy().tobytes())
        if not t.is_floating_point():
            continue
        for k, v in compress_leaf(n, t.numpy(),
                                  before[n].cpu().numpy()).items():
            out[f"state/{n}/{k}"] = torch.from_numpy(np.asarray(v))
    out["digest"] = torch.tensor(list(h.digest()), dtype=torch.uint8)
    return out


def suite_std_spatial_train(rank, out):
    """Every TRAIN_8C entry's SGD(1.0) step in float32 on TRAIN_MESHES_8C,
    and the TRAIN_F64_8C entries' in float64 on {spatial: 2}
    (``<mesh>/<family>[/f64]/...``; the {spatial: 2} steps dealt over two
    pairs of ranks, (0, 1) and (2, 3)); TRAIN_OPTS_8C in float64 on
    {data: 2, spatial: 2}; the one-device steps the test
    holds them against, dealt over the ranks (``one/<family>[/f64]/...``);
    mst's refusal of a spatial axis."""
    import dataclasses
    from rpst_torch.train.step import train_route
    d2s2 = make_mesh(TRAIN_MESHES_8C["d2s2"], torch.device("cpu"))
    s2m2 = make_mesh(TRAIN_MESHES_8C["s2m2"], torch.device("cpu"))
    # the data axis's two halves of d2s2, each a {spatial: 2} mesh
    pair = dataclasses.replace(d2s2, shape={"spatial": 2},
                               axes={"spatial": d2s2.axis("spatial")})
    jobs = [(n, o, False) for n, o in TRAIN_8C] + [
        (n, o, True) for n, o in TRAIN_F64_8C]
    opts = [(n, o, True) for n, o in TRAIN_OPTS_8C]

    def run(mname, mesh, net, over, f64):
        key = f"{mname}/{family_id(net, over)}" + ("/f64" if f64 else "")
        for k, v in train_step_8c(net, over, mesh, f64).items():
            out[f"{key}/{k}"] = v
    for i, (net, over, f64) in enumerate(jobs + opts):
        if i % dist.get_world_size() == rank:
            run("one", None, net, over, f64)
    for i, (net, over, f64) in enumerate(jobs):
        if i % 2 == d2s2.axis("data").index:
            run("s2", pair, net, over, f64)
    for mname, mesh in (("d2s2", d2s2), ("s2m2", s2m2)):
        for net, over in TRAIN_8C:
            run(mname, mesh, net, over, False)
    for net, over, f64 in opts:
        run("d2s2", d2s2, net, over, f64)
    try:
        train_route(build_model(load_config(dict(TINY, network="mst"))),
                    pair)
    except ValueError as err:
        out["mst_refusal"] = torch.tensor(list(str(err).encode()),
                                          dtype=torch.uint8)


def main():
    suite, rank, world, init, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=world, rank=rank)
    out = {}
    try:
        {"spatial": suite_spatial, "dp": suite_dp, "tp": suite_tp,
         "sanet_spatial": suite_sanet_spatial,
         "std_spatial": suite_std_spatial,
         "std_spatial_train": suite_std_spatial_train,
         "tp_fixture": suite_tp_fixture, "accum": suite_accum}[suite](
            rank, out)
        dist.barrier()
    finally:
        torch.save({k: v.detach().cpu() for k, v in out.items()},
                   Path(out_dir) / f"rank{rank}.pt")
        dist.destroy_process_group()


if __name__ == "__main__":
    main()


def run_ranks(suite: str, world: int, tmp: Path, timeout: float):
    """Run ``suite`` on ``world`` ranks (processes of this file) under
    ``tmp`` and return each rank's saved dict; raises with the ranks'
    output if one fails or the run outlasts ``timeout`` seconds."""
    import os
    import subprocess
    tmp.mkdir(parents=True, exist_ok=True)
    init = tmp / "init"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(r), str(world), str(init),
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError(f"{suite} on {world} ranks outlasted {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{suite} on {world} ranks failed:\n"
                           + "\n".join(f"--- rank {r}\n{log[-3000:]}"
                                       for r, log in enumerate(logs)))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=True)
            for r in range(world)]
