"""The port's sharding rules (``sharding/rules.py``, the ``*_spec``
functions, ``launch/specs.py``, ``launch/mesh.py``) against the JAX
package's, with no process spawned.

The reference's rules run on a ``jax.sharding.AbstractMesh``, which needs
no devices; the port's on its ``rules.AbstractMesh``. For every arch of
``list_archs()`` (full and reduced), the meshes (2, 2), (4, 2), (1, 4)
and (2, 16, 16), ``fsdp`` on and off and both ``moe_weight_mode``s:
``tree_specs`` over ``param_spec`` equal leaf for leaf, and so do
``cache_shardings`` and ``batch_shardings`` of every shape cell. Then
``logical_to_spec``'s divisibility rules, ``sensor_specs``,
``make_production_mesh`` refused in a world of 4, and a world of one
process on a (1, 1) mesh bit for bit with the path without a mesh.
"""
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JMesh

from repro.configs import RunConfig as JRun
from repro.configs import get_config as j_get_config
from repro.configs import get_shape as j_get_shape
from repro.configs import reduced as j_reduced
from repro.core import bank as j_bank
from repro.core import filters as j_filters
from repro.launch import specs as j_specs
from repro.models import model as j_model
from repro.sharding import rules as j_rules
from repro_torch.configs import (RunConfig, get_config, get_shape,
                                 list_archs, reduced)
from repro_torch.configs.base import MoEConfig
from repro_torch.core import bank as t_bank
from repro_torch.core import filters as t_filters
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.steps import (make_decode_step, make_encode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_lib
from repro_torch.optim import adamw
from repro_torch.sharding import rules

MESHES = [((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((1, 4), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MODES = ("gather", "tp2d")


def _ids(m):
    return "x".join(map(str, m[0]))


def _configs(arch, red):
    if red:
        return reduced(get_config(arch)), j_reduced(j_get_config(arch))
    return get_config(arch), j_get_config(arch)


@functools.lru_cache(maxsize=None)
def _abstract(arch, red):
    """(the port's meta parameters, the reference's ShapeDtypeStructs)."""
    cfg, jcfg = _configs(arch, red)
    return model_lib.abstract_params(cfg), j_model.abstract_params(jcfg)


def _contexts(shape, names, fsdp, mode):
    return (rules.make_context(rules.AbstractMesh(shape, names), fsdp=fsdp,
                               moe_weight_mode=mode),
            j_rules.make_context(JMesh(shape, names), fsdp=fsdp,
                                 moe_weight_mode=mode))


def _flat_port(tree, prefix=""):
    """{path: spec} of a port spec tree (dicts and NamedTuples)."""
    if rules.is_spec(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = zip(tree._fields, tree)
    out = {}
    for k, v in items:
        out.update(_flat_port(v, f"{prefix}/{k}"))
    return out


def _flat_ref(tree):
    """{path: spec tuple} of a reference tree of PartitionSpecs or
    NamedShardings, keyed as ``_flat_port``."""
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec")
        or type(x).__name__ == "PartitionSpec")[0]
    for path, leaf in leaves:
        key = "".join(f"/{getattr(p, 'key', getattr(p, 'name', p))}"
                      for p in path)
        out[key] = tuple(getattr(leaf, "spec", leaf))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no_fsdp"])
@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
@pytest.mark.parametrize("red", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_the_reference(arch, red, mesh, fsdp, mode):
    cfg, jcfg = _configs(arch, red)
    ctx, jctx = _contexts(*mesh, fsdp, mode)
    tparams, jparams = _abstract(arch, red)
    got = _flat_port(rules.tree_specs(model_lib.param_spec(cfg), tparams,
                                      ctx))
    want = _flat_ref(j_rules.tree_specs(j_model.param_spec(jcfg), jparams,
                                        jctx))
    assert got == want
    # the spec tree covers every leaf of the port's parameters
    assert set(got) == set(_flat_port(rules.map_specs(
        lambda a: a, model_lib.param_spec(cfg))))


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
@pytest.mark.parametrize("arch", list_archs())
def test_cache_and_batch_specs_match_the_reference(arch, mesh):
    cfg, jcfg = _configs(arch, False)
    for fsdp in (True, False):
        ctx, jctx = _contexts(*mesh, fsdp, "gather")
        for name in SHAPES:
            shape, jshape = get_shape(name), j_get_shape(name)
            if not cfg.is_encoder_only or shape.kind != "decode":
                got = _flat_port(specs_lib.cache_shardings(cfg, shape, ctx))
                want = _flat_ref(j_specs.cache_shardings(jcfg, jshape,
                                                         jctx))
                assert got == want, name
            for mb in (1, 4):
                got = specs_lib.batch_shardings(
                    cfg, shape, RunConfig(microbatches=mb), ctx)
                want = j_specs.batch_shardings(
                    jcfg, jshape, JRun(microbatches=mb), jctx)
                assert got == {k: tuple(v.spec) for k, v in want.items()}
    tb = specs_lib.batch_specs(cfg, get_shape("train_4k"),
                               RunConfig(microbatches=4))
    jb = j_specs.batch_specs(jcfg, j_get_shape("train_4k"), JRun(
        microbatches=4))
    assert {k: tuple(v.shape) for k, v in tb.items()} == {
        k: tuple(v.shape) for k, v in jb.items()}


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
def test_logical_to_spec_divisibility(mesh):
    """The reference's unit (tests/test_sharding.py:28) and a sweep of
    axes and dims on both packages."""
    ctx, jctx = _contexts(*mesh, True, "gather")
    data = rules.entry(ctx.data_axes)
    # kv = 1 (MQA) degrades to replication; divisible dims shard
    assert rules.logical_to_spec(("embed", "kv", None), (64, 1, 16),
                                 ctx)[1] is None
    assert rules.logical_to_spec(("embed", "heads", None), (64, 32, 16),
                                 ctx)[1:] == ("model", None)
    # the embed axis FSDP-shards once a leaf
    assert rules.logical_to_spec(("embed", "embed"), (64, 64), ctx) == (
        data, None)
    names = ("vocab", "embed", "heads", "kv", "mlp", "experts", "ssm",
             "moe_d", "moe_f", "embed_noshard", None)
    rng = np.random.default_rng(len(mesh[0]))
    for _ in range(200):
        axes = tuple(names[i] for i in rng.integers(0, len(names), 3))
        dims = tuple(int(d) for d in rng.choice([1, 3, 8, 48, 49155, 1024],
                                                3))
        for fsdp in (True, False):
            for mode in MODES:
                c, jc = _contexts(*mesh, fsdp, mode)
                assert rules.logical_to_spec(axes, dims, c) == tuple(
                    j_rules.logical_to_spec(axes, dims, jc)), (axes, dims)


@pytest.mark.parametrize("imm", [False, True], ids=["lkf", "imm"])
def test_sensor_specs_match_the_reference(imm):
    if imm:
        tb = t_bank.init_imm_bank(t_filters.make_imm(), 16, device="cpu")
        jb = j_bank.init_imm_bank(j_filters.make_imm(), 16)
    else:
        tb = t_bank.init_bank(t_filters.get_filter("lkf"), 16, device="cpu")
        jb = j_bank.init_bank(j_filters.get_filter("lkf"), 16)
    tb = t_bank.stack_sensor_banks(tb, 4)
    jb = j_bank.stack_sensor_banks(jb, 4)
    for mesh in MESHES:
        ctx, jctx = _contexts(*mesh, True, "gather")
        got = rules.sensor_specs(t_bank.bank_sensor_axes(tb), tb, ctx)
        want = j_rules.sensor_specs(j_bank.bank_sensor_axes(jb), jb, jctx)
        assert tuple(got) == tuple(tuple(w) for w in want)


def test_contexts_refuse_what_they_cannot_run():
    with pytest.raises(ValueError, match="attn_impl"):
        rules.ShardingContext(attn_impl="xla")
    with pytest.raises(ValueError, match="moe_weight_mode"):
        rules.ShardingContext(moe_weight_mode="ep")
    with pytest.raises(ValueError, match="data axes"):
        rules.ShardingContext(rules.AbstractMesh((2, 2), ("model", "data")))
    ctx = rules.make_context(rules.AbstractMesh((2, 16, 16),
                                                ("pod", "data", "model")))
    assert ctx.data_axes == ("pod", "data")
    assert (ctx.data_size, ctx.model_size) == (32, 16)
    assert rules.make_context(None).mesh is None
    # every arch builds its steps on the mesh, the SSM mixer and the
    # frontends too, and hubert its encode step
    run = RunConfig()
    for arch in ("mamba2-130m", "internvl2-2b"):
        cfg = reduced(get_config(arch))
        for step in (make_prefill_step(cfg, ctx), make_decode_step(cfg, ctx),
                     make_train_step(cfg, run, ctx)):
            assert callable(step)
    assert callable(make_encode_step(reduced(get_config("hubert-xlarge")),
                                     ctx))
    assert not hasattr(model_lib, "check_mesh")


def test_make_production_mesh_refuses_a_world_of_four(monkeypatch):
    monkeypatch.setattr(mesh_lib.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh_lib.dist, "get_world_size", lambda: 4)
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                          device_type="cpu")
    monkeypatch.setattr(mesh_lib.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield mesh_lib.make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def _served_and_trained(cfg, params, ctx, mesh, tokens):
    """A prefill, 3 greedy decode steps and 2 float32 train steps of
    ``cfg``: the logits, the metrics and the master weights."""
    p = (rules.shard_tree(params, specs_lib.param_shardings(cfg, ctx), ctx)
         if mesh else params)
    logits, caches = make_prefill_step(cfg, ctx)(p, {"tokens": tokens})
    out = [logits]
    for i in range(3):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        logits, caches = make_decode_step(cfg, ctx)(
            p, {"token": tok, "cache_pos": tokens.shape[1] + i}, caches)
        out.append(logits)
    run = RunConfig(microbatches=2, remat="none", learning_rate=1e-3,
                    warmup_steps=1)
    state = adamw.init_train_state(params)
    step = make_train_step(cfg, run, ctx, compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(8)
    batch = {k: torch.randint(0, cfg.vocab, (2, 2, tokens.shape[1]),
                              generator=gen) for k in ("tokens", "labels")}
    for _ in range(2):
        state, m = step(state, batch)
        out += [m[k] for k in ("loss", "grad_norm")]
    return out + adamw.tree_leaves(state.master)


def test_a_one_rank_mesh_is_the_path_without_a_mesh(world_of_one):
    """Prefill, decode (flash), apply_moe and two train steps on a (1, 1)
    mesh equal the same calls without a mesh bit for bit; so do reduced
    mamba2's prefill, decode and train steps (the SSM mixer) and reduced
    hubert's encode step (the audio frontend)."""
    cfg = reduced(get_config("granite-moe-1b-a400m"), d_model=64, vocab=64,
                  seq=16)
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu", torch.float32)
    tokens = torch.randint(0, 64, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    mamba = reduced(get_config("mamba2-130m"), d_model=64, vocab=64, seq=16)
    m_params = model_lib.init_params(mamba, torch.Generator().manual_seed(5),
                                     "cpu", torch.float32)
    hubert = reduced(get_config("hubert-xlarge"), d_model=64, vocab=64,
                     seq=16)
    h_params = model_lib.init_params(hubert,
                                     torch.Generator().manual_seed(6), "cpu",
                                     torch.float32)
    embeds = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(7))
    runs = []
    for mesh in (None, world_of_one):
        ctx = rules.make_context(mesh, attn_impl="flash")
        p = (rules.shard_tree(params, specs_lib.param_shardings(cfg, ctx),
                              ctx) if mesh else params)
        logits, caches = make_prefill_step(cfg, ctx)(p, {"tokens": tokens})
        out = [logits]
        tok = logits[:, -1].argmax(-1, keepdim=True)
        for i in range(3):
            logits, caches = make_decode_step(cfg, ctx)(
                p, {"token": tok, "cache_pos": 16 + i}, caches)
            out.append(logits)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        moe_cfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=8)
        mp = moe_lib.moe_init(torch.Generator().manual_seed(2), moe_cfg, 16,
                              "swiglu", "cpu", torch.float32)
        x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(3))
        out += list(moe_lib.apply_moe(mp, x, moe_cfg, "swiglu", ctx,
                                      "factor"))
        run = RunConfig(microbatches=2, remat="none", grad_compression=True,
                        learning_rate=1e-3, warmup_steps=1)
        state = adamw.init_train_state(params, True)
        step = make_train_step(cfg, run, ctx, compute_dtype=torch.float32)
        batch = {"tokens": torch.randint(0, 64, (2, 2, 16)),
                 "labels": torch.randint(0, 64, (2, 2, 16))}
        torch.manual_seed(4)
        batch = {k: torch.randint(0, 64, (2, 2, 16)) for k in batch}
        for _ in range(2):
            state, m = step(state, batch)
            out += [m[k] for k in ("loss", "grad_norm", "aux")]
        out += adamw.tree_leaves(state.master) + adamw.tree_leaves(state.ef)
        out += _served_and_trained(mamba, m_params, ctx, mesh, tokens)
        hp = (rules.shard_tree(h_params, specs_lib.param_shardings(
            hubert, ctx), ctx) if mesh else h_params)
        out.append(make_encode_step(hubert, ctx)(hp, {"embeds": embeds}))
        runs.append(out)
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("busy,why", [(False, "stall"), (True, "deadline")])
def test_watch_tells_a_stall_from_a_slow_child(busy, why, monkeypatch):
    """``local_world.watch``: a child that uses no CPU is stopped after the
    stall window, one that computes runs on to the wall-clock deadline;
    both are returned for the caller to kill. (A fifth of a CPU second a
    window counts as progress here, so a crowded host still computes.)"""
    import subprocess
    import sys
    import time

    from repro_torch.launch import local_world

    monkeypatch.setattr(local_world, "PROGRESS_CPU_S", 0.2)
    code = ("while True: pass" if busy else "import time; time.sleep(60)")
    p = subprocess.Popen([sys.executable, "-c", code])
    try:
        t0 = time.monotonic()
        hung, got = local_world.watch([p], t0 + 4.0, stall=1.5)
        took = time.monotonic() - t0
        assert hung == [p] and got == why
        assert (took >= 3.9) if busy else (1.4 <= took < 3.5)
        if busy:
            assert local_world.cpu_seconds(p.pid) > 0.2
    finally:
        p.kill()
        p.wait()
    assert local_world.watch([p], time.monotonic() + 1.0, stall=1.5) == (
        [], None)
