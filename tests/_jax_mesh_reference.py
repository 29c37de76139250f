"""The JAX package's side of ``tests/test_torch_mesh.py``: every case of
the port's 4-rank world run by the reference on a mesh of 4 XLA host
devices, from the same numpy inputs.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_mesh_reference.py INPUTS.npz OUT.npz

The cases and the names of the arrays written are those of
``tests/_torch_mesh_worker.py`` (``_mesh_cases.py`` holds both sides'
shared settings).

The cases run in THREADS threads: each traces and compiles its programs
on its own, and runs them under one lock (``run``), so that no two
programs with collectives share the 4 host devices at once. Every step
function is compiled once: the train state's and the caches' layouts
are fixed in and out (``launch/specs.py``'s shardings)."""
from __future__ import annotations

import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import _mesh_cases as mc  # noqa: E402
from repro import compat  # noqa: E402
from repro.configs import RunConfig, get_config, reduced  # noqa: E402
from repro.configs.base import MoEConfig, ShapeConfig  # noqa: E402
from repro.distributed.compression import compressed_psum  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.specs import cache_shardings, state_shardings  # noqa
from repro.launch.steps import (make_decode_step,  # noqa: E402
                                make_encode_step, make_prefill_step,
                                make_train_step)
from repro.models.moe import apply_moe  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro.sharding.rules import make_context  # noqa: E402


THREADS = 3
_RUN = threading.Lock()


def run(f, *args):
    """``f(*args)`` of a jitted ``f``: compiled outside the lock (the
    compile is cached for the call), run to its end under it."""
    f.lower(*args).compile()
    with _RUN:
        return jax.block_until_ready(f(*args))


def put(tree, shardings):
    with _RUN:
        return jax.block_until_ready(jax.device_put(tree, shardings))


def moe_cases(inp, out):
    mesh = make_mesh((2, 2), ("data", "model"))
    for mode, act, cap in mc.MOE_CASES:
        cfg = MoEConfig(**mc.MOE_CFG)
        p = mc.unflat(inp, f"moe/{act}/p/")
        x = jnp.asarray(inp[f"moe/{act}/x"])
        ctx = make_context(mesh, moe_weight_mode=mode)
        y, aux = run(jax.jit(
            lambda p, x: apply_moe(p, x, cfg, act, ctx, cap)), p, x)
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
    out["psum"] = np.asarray(run(jax.jit(f), jnp.asarray(inp["psum/x"])))


def lm_cfg(arch, **kw):
    return reduced(get_config(arch), **dict(mc.LM_REDUCE, **kw))


def serve(cfg, ctx, params, inp, key, name, out):
    batch = {k: jnp.asarray(inp[f"{key}/{k}"])
             for k in ("embeds", "tokens") if f"{key}/{k}" in inp}
    forced = inp[f"{key}/forced"]
    S = sum(v.shape[1] for v in batch.values())
    csh = cache_shardings(cfg, ShapeConfig("mesh", S, forced.shape[0],
                                           "decode"), ctx)
    logits, caches = run(jax.jit(make_prefill_step(cfg, ctx),
                                 out_shardings=(None, csh)), params, batch)
    out[name + "/prefill"] = np.asarray(logits)
    decode = jax.jit(make_decode_step(cfg, ctx),
                     in_shardings=(None, None, csh),
                     out_shardings=(None, csh))
    for i in range(mc.DECODE_STEPS):
        step = {"token": jnp.asarray(forced[:, i:i + 1]),
                "cache_pos": jnp.asarray(S + i, jnp.int32)}
        logits, caches = run(decode, params, step, caches)
        out[f"{name}/decode{i}"] = np.asarray(logits)


def lm_case(inp, out, arch, B, mode):
    ctx = make_context(make_mesh((2, 2), ("data", "model")),
                       attn_impl="flash", moe_weight_mode=mode)
    serve(lm_cfg(arch), ctx, mc.unflat(inp, f"lm/{arch}/p/"), inp,
          f"lm/{arch}/{B}", f"lm/{arch}/{B}/{mode}", out)


def heads_case(inp, out):
    hr = mc.HEADS_REPLICATED
    ctx = make_context(make_mesh(hr["mesh"], ("data", "model")),
                       attn_impl="flash")
    serve(lm_cfg(hr["arch"], d_model=hr["d_model"]), ctx,
          mc.unflat(inp, "heads/p/"), inp, "heads", "heads", out)


def encode_case(inp, out):
    ctx = make_context(make_mesh((2, 2), ("data", "model")),
                       attn_impl="flash")
    out["encode/logits"] = np.asarray(run(
        jax.jit(make_encode_step(lm_cfg(mc.ENCODE_ARCH), ctx)),
        mc.unflat(inp, f"lm/{mc.ENCODE_ARCH}/p/"),
        {"embeds": jnp.asarray(inp["encode/embeds"])}))


def jit_train(cfg, run_cfg, ctx, state):
    """The jitted float32 train step with the state's layout fixed in and
    out, and ``state`` put on that layout."""
    sh = state_shardings(cfg, run_cfg, ctx)
    step = jax.jit(make_train_step(cfg, run_cfg, ctx,
                                   compute_dtype=jnp.float32),
                   in_shardings=(sh, None), out_shardings=(sh, None))
    return step, put(state, sh)


def train_case(inp, out):
    cfg = lm_cfg(mc.TRAIN_ARCH)
    run_cfg = RunConfig(**mc.TRAIN_RUN)
    master = mc.unflat(inp, "train/p/")
    state = adamw.init_train_state(master, run_cfg.grad_compression)
    for leg, shape, steps in mc.TRAIN_LEGS:
        ctx = make_context(make_mesh(shape, ("data", "model")))
        step, state = jit_train(cfg, run_cfg, ctx, state)
        for i in range(steps):
            batch = {k: jnp.asarray(inp[f"train/batch{leg}_{i}/{k}"])
                     for k in ("tokens", "labels")}
            state, m = run(step, state, batch)
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


def ssm_frontend_train(inp, out, arch, steps):
    ctx = make_context(make_mesh((2, 2), ("data", "model")))
    run_cfg = RunConfig(**mc.TRAIN_RUN)
    step, state = jit_train(lm_cfg(arch), run_cfg, ctx, adamw.init_train_state(
        mc.unflat(inp, f"lm/{arch}/p/"), run_cfg.grad_compression))
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in mc.unflat(
            inp, f"ssm_train/{arch}/batch{i}/").items()}
        state, m = run(step, state, batch)
        for k in mc.TRAIN_METRICS:
            out[f"ssm_train/{arch}/{i}/{k}"] = np.asarray(m[k])
    for k, v in mc.flat(jax.tree.map(np.asarray, state.master)).items():
        out[f"ssm_train/{arch}/master/{k}"] = v


def main(argv):
    inp = dict(np.load(argv[1]))
    out = {}
    # the slowest first (reduced jamba's 8 layers compile longest)
    cases = [(ssm_frontend_train, a, n) for a, n in mc.TRAIN_CASES]
    cases += [(train_case,)]
    cases += [(lm_case, a, B, m) for a, B, m in sorted(
        mc.SSM_FRONTEND_CASES + mc.LM_CASES,
        key=lambda c: not c[0].startswith("jamba"))]
    cases += [(heads_case,), (encode_case,), (moe_cases,), (psum_case,),
              (ef_case,)]
    with ThreadPoolExecutor(THREADS) as pool:
        for f in [pool.submit(fn, inp, out, *args) for fn, *args in cases]:
            f.result()
    np.savez(argv[2], **out)


if __name__ == "__main__":
    main(sys.argv)
