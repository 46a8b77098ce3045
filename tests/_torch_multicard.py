"""Rank bodies for tests/test_torch_multicard.py, run in spawned processes
(torch.multiprocessing pickles these functions by module name).

`gloo_rank`: one rank of a 4-rank gloo world on a FileStore.  It builds the
(data 2, model 2) mesh, runs `jit_train_step` twice, `jit_prefill_step` and
`jit_decode_step` for every family in `work/inputs.pkl`, and writes
`work/out_<rank>.pkl`: each rank its local shard shapes and placements,
rank 0 also the gathered values.

`fake_world_report`: rank 0 of fake worlds of 4, 256 and 512 ranks in
turn: `make_production_mesh`'s error at 4, and at 256 and 512 the mesh and
the local shapes of every config's parameters, AdamW state, batches and
caches placed as meta DTensors by their specs.
"""
import pickle

import numpy as np
import torch

AXES = ("data", "model")


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, *xs) for xs in zip(tree, *rest)]
    return fn(tree, *rest)


def _full(tree):
    """Gathered numpy values (a collective: every rank calls it)."""
    return _map(lambda t: t.full_tensor().detach().numpy(), tree)


def _local_shapes(tree):
    return _map(lambda t: tuple(t.to_local().shape), tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def gloo_rank(rank, world, work):
    import torch.distributed as dist

    from repro_torch import configs, models, optim
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import steps
    from repro_torch.models import sharding as shd

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{work}/store",
                                                         world),
                            rank=rank, world_size=world)
    try:
        with open(f"{work}/inputs.pkl", "rb") as f:
            inputs = pickle.load(f)
        mesh = lmesh.make_model_mesh((2, 2), AXES, device_type="cpu")
        out = {}
        for fam, inp in inputs.items():
            cfg = configs.get_config(inp["arch"], smoke=True)
            model = models.build_model(cfg, shd.axis_env_from_mesh(mesh),
                                       device="cpu")
            params = _to_torch(inp["params"])
            opt = optim.adamw_init(params)
            res = {"train": []}
            for b in inp["batches"]:
                batch = _to_torch(b)
                step = steps.jit_train_step(
                    model, mesh, optim.AdamWConfig(lr=inp["lr"]), batch)
                params, opt, met = step(params, opt, batch)
                res["train"].append({k: float(v.full_tensor())
                                     for k, v in met.items()})
            placed_batch = shd.distribute(batch, step.in_specs[2], step.mesh)
            res["shapes"] = {"params": _local_shapes(params),
                             "opt": _local_shapes(opt),
                             "batch": _local_shapes(placed_batch)}
            res["cut_dims"] = sorted(
                {i for t in _leaves(params) for i, p in
                 enumerate(t.placements) if p.is_shard()})
            res["params"], res["opt"] = _full(params), _full(opt)
            p0 = _to_torch(inp["params"])
            prompt = {"tokens": _to_torch(inp["prompt"])}
            pre = steps.jit_prefill_step(model, mesh, prompt)
            res["prefill"] = _full(pre(p0, prompt))
            cache, tok = _to_torch(inp["cache"]), {"tokens":
                                                   _to_torch(inp["token"])}
            dec = steps.jit_decode_step(model, mesh, cache, tok,
                                        inp["token"].shape[0])
            logits, new_cache = dec(p0, cache, tok)
            res["shapes"]["cache"] = _local_shapes(new_cache)
            res["decode"] = _full((logits, new_cache))
            out[fam] = res
        with open(f"{work}/out_{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def fake_world_report(archs, shape_names):
    """{("error", multi_pod): make_production_mesh's message at 4 ranks,
    256: ..., 512: ...} (see _fake_world_shapes)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import mesh as lmesh
    rep = {}
    for n in (4, 256, 512):
        dist.init_process_group("fake", rank=0, world_size=n,
                                store=FakeStore())
        try:
            if n == 4:
                for multi in (False, True):
                    try:
                        lmesh.make_production_mesh(multi_pod=multi,
                                                   device_type="cpu")
                    except RuntimeError as e:
                        rep[("error", multi)] = str(e)
            else:
                rep[n] = _fake_world_shapes(n == 512, archs, shape_names)
        finally:
            dist.destroy_process_group()
    return rep


def _fake_world_shapes(multi_pod, archs, shape_names):
    """{"mesh": (shape, axis names), arch: {"params", "opt", shape:
    {"batch"(, "cache")}}} of local shapes on the production mesh."""
    from repro_torch import configs, models
    from repro_torch.configs.shapes import SHAPES, input_specs, runnable
    from repro_torch.launch import dryrun, mesh as lmesh, steps
    from repro_torch.models import sharding as shd

    mesh = lmesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    pmesh = shd.spmd_mesh(mesh)
    ax = shd.axis_env_from_mesh(mesh)
    place = lambda tree, specs: _local_shapes(shd.distribute(tree, specs,
                                                             pmesh))
    out = {"mesh": (tuple(mesh.shape), tuple(mesh.mesh_dim_names))}
    for arch in archs:
        cfg = configs.get_config(arch)
        model = models.build_model(cfg, ax, device="meta")
        params = model.init_abstract()
        pspecs = model.param_specs()
        res = {"params": place(params, pspecs),
               "opt": place(dryrun._abstract_opt(params),
                            steps.opt_specs(pspecs))}
        for name in shape_names:
            if not runnable(cfg, name):
                continue
            sp = SHAPES[name]
            res[name] = {}
            if sp.kind == "decode":
                full = input_specs(cfg, name, model=model)
                batch, cache = {"tokens": full["tokens"]}, full["cache"]
                res[name]["cache"] = place(
                    cache, steps.cache_specs(cfg, cache, ax, sp.batch))
            else:
                batch = input_specs(cfg, name)
            res[name]["batch"] = place(batch, steps.batch_specs(batch, ax))
        out[arch] = res
    return out
