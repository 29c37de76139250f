"""The port's side of the mesh tests, run on every rank by
``repro_torch.launch.local_world``: ``worker``, one rank of the 4-process
``gloo`` world of ``tests/test_torch_mesh.py`` on the CPU, and
``card_job``, one rank of the 2-process world of
``tests/test_torch_gpu.py``'s mesh cases on one card; and
``make_inputs``, the numpy inputs of both.

Every rank runs every case (SPMD) and returns the results, the global
tensors gathered from the ranks' blocks. Each case starts from the full
numpy inputs, cuts this rank's blocks by the specs
(``sharding.rules.shard_tree``) and gathers the outputs back."""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

import _mesh_cases as mc
from repro_torch.checkpoint import ckpt
from repro_torch.configs import RunConfig, get_config, reduced
from repro_torch.configs.base import MoEConfig, ShapeConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.compression import compressed_psum, ef_compress
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.steps import (make_decode_step, make_encode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import moe as moe_lib
from repro_torch.models import model as model_lib
from repro_torch.models.model import init_params
from repro_torch.optim import adamw
from repro_torch.sharding import rules


def make_inputs(rng):
    inp = {}
    u = rng.normal(size=mc.MOE_D)
    u /= np.linalg.norm(u)
    for act in ("swiglu", "squared_relu"):
        p = moe_lib.moe_init(torch.Generator().manual_seed(1),
                             MoEConfig(**mc.MOE_CFG), mc.MOE_D, act, "cpu",
                             torch.float32)
        p = {k: v.numpy().copy() for k, v in p.items()}
        # a router skewed to expert 0: "factor" capacity drops entries
        p["router"][:, 0] = 4.0 * u
        inp.update(mc.flat(p, f"moe/{act}/p/"))
        inp[f"moe/{act}/x"] = (rng.normal(size=mc.MOE_X)
                               + 2.0 * u).astype(np.float32)
    inp["psum/x"] = (3.0 * rng.normal(size=mc.PSUM_X)).astype(np.float32)
    for arch in sorted({a for a, _, _ in mc.LM_CASES}):
        cfg = lm_cfg(arch)
        p = init_params(cfg, torch.Generator().manual_seed(2), "cpu",
                        torch.float32)
        inp.update(mc.flat({k: _np(v) for k, v in p.items()},
                           f"lm/{arch}/p/"))
    for arch, B, _ in mc.LM_CASES:
        inp[f"lm/{arch}/{B}/tokens"] = rng.integers(
            0, mc.LM_REDUCE["vocab"], (B, mc.PROMPT)).astype(np.int32)
        inp[f"lm/{arch}/{B}/forced"] = rng.integers(
            0, mc.LM_REDUCE["vocab"], (B, mc.DECODE_STEPS)).astype(np.int32)
    for B in (1, 4):  # the card's cases
        inp[f"card/{B}/tokens"] = rng.integers(
            0, mc.LM_REDUCE["vocab"], (B, mc.PROMPT)).astype(np.int32)
        inp[f"card/{B}/forced"] = rng.integers(
            0, mc.LM_REDUCE["vocab"], (B, 3)).astype(np.int32)
    cfg = lm_cfg(mc.TRAIN_ARCH)
    p = init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                    torch.float32)
    flat = mc.flat({k: _np(v) for k, v in p.items()})
    inp.update({f"train/p/{k}": v for k, v in flat.items()})
    for k, v in flat.items():
        inp[f"ef/g/{k}"] = rng.normal(size=v.shape).astype(np.float32)
        inp[f"ef/e/{k}"] = (1e-3 * rng.normal(size=v.shape)).astype(
            np.float32)
    S = mc.LM_REDUCE["seq"]
    shape = (mc.TRAIN_RUN["microbatches"], mc.TRAIN_BATCH, S + 1)
    for leg, _, steps in mc.TRAIN_LEGS:
        for i in range(steps):
            seq = rng.integers(0, mc.LM_REDUCE["vocab"], shape)
            inp[f"train/batch{leg}_{i}/tokens"] = seq[..., :-1].astype(
                np.int32)
            inp[f"train/batch{leg}_{i}/labels"] = seq[..., 1:].astype(
                np.int32)
    ssm_frontend_inputs(np.random.default_rng(1), inp)
    return inp


def lm_cfg(arch, **kw):
    return reduced(get_config(arch), **dict(mc.LM_REDUCE, **kw))


def heads_cfg():
    return lm_cfg(mc.HEADS_REPLICATED["arch"],
                  d_model=mc.HEADS_REPLICATED["d_model"])


def serve_inputs(rng, inp, cfg, key, B):
    """A prompt (the vision stub's patch embeddings before the tokens)
    and the tokens the decode steps are fed."""
    if cfg.frontend:
        inp[f"{key}/embeds"] = rng.normal(
            size=(B, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
    inp[f"{key}/tokens"] = rng.integers(
        0, cfg.vocab, (B, mc.PROMPT)).astype(np.int32)
    inp[f"{key}/forced"] = rng.integers(
        0, cfg.vocab, (B, mc.DECODE_STEPS)).astype(np.int32)


def ssm_frontend_inputs(rng, inp):
    """The inputs of the SSM and frontend cases, from their own generator
    (the other cases' draws stay as they were)."""
    archs = ({a for a, _, _ in mc.SSM_FRONTEND_CASES} | {mc.ENCODE_ARCH}
             | {a for a, _ in mc.TRAIN_CASES})
    for arch in sorted(archs):
        p = init_params(lm_cfg(arch), torch.Generator().manual_seed(2),
                        "cpu", torch.float32)
        inp.update(mc.flat(_np(p), f"lm/{arch}/p/"))
    for arch, B, _ in mc.SSM_FRONTEND_CASES:
        serve_inputs(rng, inp, lm_cfg(arch), f"lm/{arch}/{B}", B)
    cfg = heads_cfg()
    p = init_params(cfg, torch.Generator().manual_seed(2), "cpu",
                    torch.float32)
    inp.update(mc.flat(_np(p), "heads/p/"))
    serve_inputs(rng, inp, cfg, "heads", mc.HEADS_REPLICATED["B"])
    cfg = lm_cfg(mc.ENCODE_ARCH)
    inp["encode/embeds"] = rng.normal(
        size=(mc.ENCODE_B, mc.LM_REDUCE["seq"], cfg.d_model)).astype(
            np.float32)
    S, mb = mc.LM_REDUCE["seq"], mc.TRAIN_RUN["microbatches"]
    for arch, steps in mc.TRAIN_CASES:
        cfg = lm_cfg(arch)
        nf = cfg.frontend_positions
        for i in range(steps):
            key = f"ssm_train/{arch}/batch{i}"
            seq = rng.integers(0, cfg.vocab, (mb, mc.TRAIN_BATCH, S + 1))
            if nf:
                inp[f"{key}/embeds"] = rng.normal(
                    size=(mb, mc.TRAIN_BATCH, nf, cfg.d_model)).astype(
                        np.float32)
            inp[f"{key}/tokens"] = seq[..., nf:-1].astype(np.int32)
            inp[f"{key}/labels"] = seq[..., 1:].astype(np.int32)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


def tensors(tree):
    return adamw.tree_map(lambda a: torch.as_tensor(np.asarray(a)).clone(),
                          tree)


def numpy_tree(tree):
    return adamw.tree_map(lambda t: t.detach().numpy(), tree)


def same_state(a, b) -> bool:
    """Every tensor of two train states equal bit for bit."""
    pairs = list(zip(adamw.tree_leaves(a), adamw.tree_leaves(b)))
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in pairs)


def all_ranks(flag: bool) -> bool:
    """True on every rank where ``flag`` holds on every rank."""
    t = torch.tensor(float(flag))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def moe_cases(inp, out):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = MoEConfig(**mc.MOE_CFG)
    for mode, act, cap in mc.MOE_CASES:
        ctx = rules.make_context(mesh, moe_weight_mode=mode)
        p = tensors(mc.unflat(inp, f"moe/{act}/p/"))
        specs = rules.tree_specs(moe_lib.moe_spec(act), p, ctx)
        x = torch.as_tensor(inp[f"moe/{act}/x"])
        y, aux = moe_lib.apply_moe(rules.shard_tree(p, specs, ctx),
                                   rules.shard(x, (ctx.data_axes,), ctx),
                                   cfg, act, ctx, cap)
        name = f"moe/{mode}/{act}/{cap}"
        out[name + "/out"] = coll.all_gather(y, mesh, ctx.data_axes).numpy()
        out[name + "/aux"] = aux.numpy()
        # the same inputs on one device: at "factor" capacity the local
        # queues drop other entries
        y1, aux1 = moe_lib.apply_moe(p, x, cfg, act, None, cap)
        out[name + "/one_device"] = y1.numpy()
        out[name + "/one_device_aux"] = aux1.numpy()


def psum_case(inp, out):
    mesh = make_mesh((4, 1), ("data", "model"), "cpu")
    x = torch.as_tensor(inp["psum/x"])
    rows = x.shape[0] // mc.WORLD
    r = dist.get_rank()
    got = compressed_psum(x[r * rows:(r + 1) * rows], mesh, "data")
    out["psum"] = coll.all_gather(got, mesh, "data").numpy()
    # the plain version: the int8 codes summed on one rank, times the scale
    smax = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / smax), -127, 127).to(torch.int8)
    plain = sum(q[i * rows:(i + 1) * rows].float()
                for i in range(mc.WORLD)) * smax
    out["psum_plain"] = plain.repeat(mc.WORLD, 1).numpy()


def ef_case(inp, out):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = lm_cfg(mc.TRAIN_ARCH)
    ctx = rules.make_context(mesh)
    specs = model_lib.param_specs(cfg, ctx)
    g, e = (rules.shard_tree(tensors(mc.unflat(inp, k)), specs, ctx)
            for k in ("ef/g/", "ef/e/"))
    deq, new_e = ef_compress(g, e, ctx, specs)
    for tag, tree in (("deq", deq), ("e", new_e)):
        for k, v in mc.flat(numpy_tree(rules.unshard_tree(
                tree, specs, ctx))).items():
            out[f"ef/{tag}/{k}"] = v


def cache_blocks_ok(cfg, ctx, caches, B, T) -> bool:
    """Whether every cache leaf on this rank is the block of
    ``cache_shardings``'s spec for a batch of B and T positions."""
    shape = ShapeConfig("mesh", T, B, "decode")
    ok = []
    rules.map_specs(
        lambda spec, full, t: ok.append(tuple(t.shape) == tuple(
            full[rules.local_slices(spec, full.shape, ctx.mesh)].shape)),
        specs_lib.cache_shardings(cfg, shape, ctx),
        specs_lib.cache_specs(cfg, shape, torch.float32), caches,
        is_leaf=rules.is_spec)
    return all(ok)


def serve(cfg, ctx, full, inp, key, out, name):
    """Prefill of ``key``'s prompt and DECODE_STEPS decode steps fed its
    tokens, on ``ctx``'s mesh: the logits of each, and whether every rank
    holds the cache blocks ``cache_shardings`` names."""
    params = rules.shard_tree(full, specs_lib.param_shardings(cfg, ctx), ctx)
    batch = {k: torch.as_tensor(inp[f"{key}/{k}"])
             for k in ("embeds", "tokens") if f"{key}/{k}" in inp}
    batch["tokens"] = batch["tokens"].long()
    forced = torch.as_tensor(inp[f"{key}/forced"]).long()
    logits, caches = make_prefill_step(cfg, ctx)(params, batch)
    out[name + "/prefill"] = logits.numpy()
    B, S = forced.shape[0], sum(v.shape[1] for v in batch.values())
    out[name + "/cache_blocks"] = np.asarray(all_ranks(
        cache_blocks_ok(cfg, ctx, caches, B, S)))
    decode = make_decode_step(cfg, ctx)
    for i in range(mc.DECODE_STEPS):
        logits, caches = decode(params, {"token": forced[:, i:i + 1],
                                         "cache_pos": S + i}, caches)
        out[f"{name}/decode{i}"] = logits.numpy()


def lm_cases(inp, out):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    for arch, B, mode in mc.LM_CASES + mc.SSM_FRONTEND_CASES:
        cfg = lm_cfg(arch)
        ctx = rules.make_context(mesh, attn_impl="flash",
                                 moe_weight_mode=mode)
        serve(cfg, ctx, tensors(mc.unflat(inp, f"lm/{arch}/p/")), inp,
              f"lm/{arch}/{B}", out, f"lm/{arch}/{B}/{mode}")


def heads_case(inp, out):
    """Reduced mamba2 whose H = 6 heads a model axis of 4 does not divide:
    every rank runs every head."""
    hr = mc.HEADS_REPLICATED
    ctx = rules.make_context(make_mesh(hr["mesh"], ("data", "model"),
                                       "cpu"), attn_impl="flash")
    serve(heads_cfg(), ctx, tensors(mc.unflat(inp, "heads/p/")), inp,
          "heads", out, "heads")


def encode_case(inp, out):
    """Reduced hubert's encode step on (2, 2): the frame embeddings' rows
    over data, the heads and the vocab over model."""
    cfg = lm_cfg(mc.ENCODE_ARCH)
    ctx = rules.make_context(make_mesh((2, 2), ("data", "model"), "cpu"),
                             attn_impl="flash")
    params = rules.shard_tree(
        tensors(mc.unflat(inp, f"lm/{mc.ENCODE_ARCH}/p/")),
        specs_lib.param_shardings(cfg, ctx), ctx)
    out["encode/logits"] = make_encode_step(cfg, ctx)(
        params, {"embeds": torch.as_tensor(inp["encode/embeds"])}).numpy()


def ssm_frontend_train(inp, out):
    """TRAIN_CASES: float32 steps on (2, 2); the metrics of each and the
    master weights after the last, gathered."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    ctx = rules.make_context(mesh)
    run = RunConfig(**mc.TRAIN_RUN)
    for arch, steps in mc.TRAIN_CASES:
        cfg = lm_cfg(arch)
        specs = specs_lib.state_shardings(cfg, run, ctx)
        state = rules.shard_tree(adamw.init_train_state(
            tensors(mc.unflat(inp, f"lm/{arch}/p/")), run.grad_compression),
            specs, ctx)
        step = make_train_step(cfg, run, ctx, compute_dtype=torch.float32)
        for i in range(steps):
            state, m = step(state, mc.unflat(inp,
                                             f"ssm_train/{arch}/batch{i}/"))
            for k in mc.TRAIN_METRICS:
                out[f"ssm_train/{arch}/{i}/{k}"] = m[k].numpy()
        gathered = rules.unshard_tree(state.master, specs.master, ctx)
        for k, v in mc.flat(numpy_tree(gathered)).items():
            out[f"ssm_train/{arch}/master/{k}"] = v


def train_case(inp, out, outdir):
    cfg = lm_cfg(mc.TRAIN_ARCH)
    run = RunConfig(**mc.TRAIN_RUN)
    full = adamw.init_train_state(tensors(mc.unflat(inp, "train/p/")),
                                  run.grad_compression)
    like = adamw.abstract_train_state(full.master)
    root = os.path.join(outdir, "ckpt")
    state = None
    for leg, shape, steps in mc.TRAIN_LEGS:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        ctx = rules.make_context(mesh)
        specs = specs_lib.state_shardings(cfg, run, ctx)
        if leg == "a":
            state = rules.shard_tree(full, specs, ctx)
        else:
            # elastic restore of the first leg's checkpoint onto this mesh:
            # every block bit for bit the saved full array's
            state, _ = ckpt.restore(root, like, device="cpu", ctx=ctx,
                                    specs=specs)
            want = rules.shard_tree(saved, specs, ctx)
            out[f"train/{leg}/restored_bitwise"] = np.asarray(
                all_ranks(same_state(state, want)))
        step = make_train_step(cfg, run, ctx, compute_dtype=torch.float32)
        for i in range(steps):
            batch = {k: inp[f"train/batch{leg}_{i}/{k}"]
                     for k in ("tokens", "labels")}
            state, m = step(state, batch)
            for k in mc.TRAIN_METRICS:
                out[f"train/{leg}/{i}/{k}"] = m[k].numpy()
        gathered = rules.unshard_tree(state, specs, ctx)
        for k, v in mc.flat(numpy_tree(gathered.master)).items():
            out[f"train/{leg}/master/{k}"] = v
        if leg == "a":
            ckpt.save(root, 3, state, ctx=ctx, specs=specs)
            saved = gathered
            written, _ = ckpt.restore(root, like, device="cpu")
            out["train/a/saved_bitwise"] = np.asarray(all_ranks(
                same_state(written, saved)))


def production_mesh_case(out):
    try:
        make_production_mesh(device_type="cpu")
    except ValueError as e:
        out["production_mesh_refused"] = np.asarray(str(e))


def worker(rank, tensors, inputs, outdir):
    """Every case on this rank; returns {name: numpy array}."""
    torch.set_num_threads(1)
    inp = dict(np.load(inputs))
    out = {}
    moe_cases(inp, out)
    psum_case(inp, out)
    ef_case(inp, out)
    lm_cases(inp, out)
    heads_case(inp, out)
    encode_case(inp, out)
    train_case(inp, out, outdir)
    ssm_frontend_train(inp, out)
    production_mesh_case(out)
    return out


def card_job(rank, passed, inputs):
    """The mesh cases of ``tests/test_torch_gpu.py`` on this rank of 2 on
    one card: ``apply_moe`` on ('data' 1, 'model' 2) ("gather", experts
    split) and on ('data' 2, 'model' 1) ("tp2d" mode, which takes the
    reference's one-device path on a model axis of one rank); reduced
    granite-moe prefilled and decoded 3 steps on attn_impl "flash" on
    (1, 2) (the cache's sequence over model) and with a batch of 1 on
    (2, 1) (over data); reduced mamba2 prefilled (ssd_scan on each rank's
    heads) and decoded 3 steps on (1, 2); ``compressed_psum`` over (2,
    1)'s data axis."""
    dev = torch.device("cuda")
    inp = dict(np.load(inputs))
    out = {}
    meshes = {"1x2": make_mesh((1, 2), ("data", "model")),
              "2x1": make_mesh((2, 1), ("data", "model"))}
    cfg = MoEConfig(**mc.MOE_CFG)
    for name, mode in (("1x2", "gather"), ("2x1", "tp2d")):
        mesh = meshes[name]
        for act in ("swiglu", "squared_relu"):
            ctx = rules.make_context(mesh, moe_weight_mode=mode)
            p = adamw.tree_map(lambda a: a.to(dev),
                               tensors(mc.unflat(inp, f"moe/{act}/p/")))
            specs = rules.tree_specs(moe_lib.moe_spec(act), p, ctx)
            x = torch.as_tensor(inp[f"moe/{act}/x"], device=dev)
            for cap in ("full", "factor"):
                y, aux = moe_lib.apply_moe(
                    rules.shard_tree(p, specs, ctx),
                    rules.shard(x, (ctx.data_axes,), ctx), cfg, act, ctx, cap)
                key = f"moe/{name}/{act}/{cap}"
                out[key] = coll.all_gather(y, mesh, ctx.data_axes).cpu()
                out[key + "/aux"] = aux.cpu()
    arch = "granite-moe-1b-a400m"
    lm = lm_cfg(arch)
    full = adamw.tree_map(lambda a: a.to(dev),
                          tensors(mc.unflat(inp, f"lm/{arch}/p/")))
    for name, B in (("1x2", 4), ("2x1", 1)):
        ctx = rules.make_context(meshes[name], attn_impl="flash")
        params = rules.shard_tree(full, specs_lib.param_shardings(lm, ctx),
                                  ctx)
        tokens = torch.as_tensor(inp[f"card/{B}/tokens"], device=dev).long()
        forced = torch.as_tensor(inp[f"card/{B}/forced"], device=dev).long()
        fd_ops.reset_launches()
        logits, caches = make_prefill_step(lm, ctx)(params,
                                                    {"tokens": tokens})
        out[f"lm/{name}/prefill"] = logits.cpu()
        for i in range(forced.shape[1]):
            logits, caches = make_decode_step(lm, ctx)(
                params, {"token": forced[:, i:i + 1],
                         "cache_pos": tokens.shape[1] + i}, caches)
            out[f"lm/{name}/decode{i}"] = logits.cpu()
        out[f"lm/{name}/flash_decode"] = fd_ops.LAUNCHES["flash_decode"]
    # reduced mamba2 on (1, 2): each rank's ssd_scan on its 4 of 8 heads
    arch = "mamba2-130m"
    ssm = lm_cfg(arch)
    ctx = rules.make_context(meshes["1x2"])
    params = rules.shard_tree(
        adamw.tree_map(lambda a: a.to(dev),
                       tensors(mc.unflat(inp, f"lm/{arch}/p/"))),
        specs_lib.param_shardings(ssm, ctx), ctx)
    tokens = torch.as_tensor(inp["card/4/tokens"], device=dev).long()
    forced = torch.as_tensor(inp["card/4/forced"], device=dev).long()
    ssd_ops.reset_launches()
    logits, caches = make_prefill_step(ssm, ctx)(params, {"tokens": tokens})
    out["ssm/prefill"] = logits.cpu()
    out["ssm/prefill_ssd_scan"] = ssd_ops.LAUNCHES["ssd_scan"]
    out["ssm/state_block"] = tuple(caches["layer0"].state.shape)
    for i in range(forced.shape[1]):
        logits, caches = make_decode_step(ssm, ctx)(
            params, {"token": forced[:, i:i + 1],
                     "cache_pos": tokens.shape[1] + i}, caches)
        out[f"ssm/decode{i}"] = logits.cpu()
    out["ssm/ssd_scan"] = ssd_ops.LAUNCHES["ssd_scan"]
    x = torch.as_tensor(inp["psum/x"], device=dev)
    rows = x.shape[0] // 2
    got = compressed_psum(x[rank * rows:(rank + 1) * rows], meshes["2x1"],
                          "data")
    out["psum"] = coll.all_gather(got, meshes["2x1"], "data").cpu()
    out["staged_bytes"] = coll.STAGED_BYTES["bytes"]
    return out
