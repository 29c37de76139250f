"""The JAX package's side of ``tests/test_torch_mesh.py``: every case of
the port's 4-rank world run by the reference on a mesh of 4 XLA host
devices, from the same numpy inputs.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_mesh_reference.py INPUTS.npz OUT.npz

The cases and the names of the arrays written are those of
``tests/_torch_mesh_worker.py`` (``_mesh_cases.py`` holds both sides'
shared settings)."""
from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import _mesh_cases as mc  # noqa: E402
from repro import compat  # noqa: E402
from repro.configs import RunConfig, get_config, reduced  # noqa: E402
from repro.configs.base import MoEConfig  # noqa: E402
from repro.distributed.compression import compressed_psum  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.steps import (make_decode_step, make_prefill_step,  # noqa
                                make_train_step)
from repro.models.moe import apply_moe  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro.sharding.rules import make_context  # noqa: E402


def moe_cases(inp, out):
    mesh = make_mesh((2, 2), ("data", "model"))
    for mode, act, cap in mc.MOE_CASES:
        cfg = MoEConfig(**mc.MOE_CFG)
        p = mc.unflat(inp, f"moe/{act}/p/")
        x = jnp.asarray(inp[f"moe/{act}/x"])
        ctx = make_context(mesh, moe_weight_mode=mode)
        y, aux = jax.jit(lambda p, x: apply_moe(p, x, cfg, act, ctx, cap))(
            p, x)
        name = f"moe/{mode}/{act}/{cap}"
        out[name + "/out"], out[name + "/aux"] = np.asarray(y), np.asarray(aux)


def ef_case(inp, out):
    from repro.distributed.compression import ef_compress

    g, e = mc.unflat(inp, "ef/g/"), mc.unflat(inp, "ef/e/")
    deq, new_e = ef_compress(g, e)
    for k, v in mc.flat(jax.tree.map(np.asarray, deq)).items():
        out[f"ef/deq/{k}"] = v
    for k, v in mc.flat(jax.tree.map(np.asarray, new_e)).items():
        out[f"ef/e/{k}"] = v


def psum_case(inp, out):
    mesh = make_mesh((4,), ("data",))
    f = compat.shard_map(lambda x: compressed_psum(x, "data"), mesh=mesh,
                         in_specs=(P("data"),), out_specs=P("data"))
    out["psum"] = np.asarray(jax.jit(f)(jnp.asarray(inp["psum/x"])))


def lm_cases(inp, out):
    for arch, B, mode in mc.LM_CASES:
        cfg = reduced(get_config(arch), **mc.LM_REDUCE)
        params = mc.unflat(inp, f"lm/{arch}/p/")
        mesh = make_mesh((2, 2), ("data", "model"))
        ctx = make_context(mesh, attn_impl="flash", moe_weight_mode=mode)
        tokens = jnp.asarray(inp[f"lm/{arch}/{B}/tokens"])
        forced = inp[f"lm/{arch}/{B}/forced"]
        name = f"lm/{arch}/{B}/{mode}"
        logits, caches = jax.jit(make_prefill_step(cfg, ctx))(
            params, {"tokens": tokens})
        out[name + "/prefill"] = np.asarray(logits)
        decode = jax.jit(make_decode_step(cfg, ctx))
        S = tokens.shape[1]
        for i in range(mc.DECODE_STEPS):
            batch = {"token": jnp.asarray(forced[:, i:i + 1]),
                     "cache_pos": jnp.asarray(S + i, jnp.int32)}
            logits, caches = decode(params, batch, caches)
            out[f"{name}/decode{i}"] = np.asarray(logits)


def train_case(inp, out):
    cfg = reduced(get_config(mc.TRAIN_ARCH), **mc.LM_REDUCE)
    run = RunConfig(**mc.TRAIN_RUN)
    master = mc.unflat(inp, "train/p/")
    state = adamw.init_train_state(master, run.grad_compression)
    for leg, shape, steps in mc.TRAIN_LEGS:
        ctx = make_context(make_mesh(shape, ("data", "model")))
        step = jax.jit(make_train_step(cfg, run, ctx,
                                       compute_dtype=jnp.float32))
        for i in range(steps):
            batch = {k: jnp.asarray(inp[f"train/batch{leg}_{i}/{k}"])
                     for k in ("tokens", "labels")}
            state, m = step(state, batch)
            for k in mc.TRAIN_METRICS:
                out[f"train/{leg}/{i}/{k}"] = np.asarray(m[k])
        for k, v in mc.flat(jax.tree.map(np.asarray, state.master)).items():
            out[f"train/{leg}/master/{k}"] = v
        if leg == "a":
            # the later legs start from the first leg's end, as a restore
            # would give it
            after_a = state
        else:
            state = after_a


def main(argv):
    inp = dict(np.load(argv[1]))
    out = {}
    moe_cases(inp, out)
    psum_case(inp, out)
    ef_case(inp, out)
    lm_cases(inp, out)
    train_case(inp, out)
    np.savez(argv[2], **out)


if __name__ == "__main__":
    main(sys.argv)
