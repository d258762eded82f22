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
F64_FAMILIES = [("sel_multi_adain", {}), ("spade", {"spade_norm": "batch"}),
                ("seg_adain", {})]


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


def main():
    suite, rank, world, init, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=world, rank=rank)
    out = {}
    try:
        {"spatial": suite_spatial, "dp": suite_dp}[suite](rank, out)
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
