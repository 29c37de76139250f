"""Every arch of ``list_archs()`` served by the port, and the MoE and
frontend archs against the JAX package.

Twins of the reference's per-arch smoke tests
(``tests/test_archs_smoke.py:66`` ``test_forward_shapes`` and ``:81``
``test_prefill_then_decode``): reduced configs, bf16 parameters, the
frontend archs fed precomputed embeddings as the reference's
``make_batch`` builds them (vision: 8 patch positions before the text;
audio: every position).

Parity: reduced granite-moe-1b-a400m, qwen3-moe-235b-a22b,
jamba-1.5-large-398b (attention, Mamba-2 and MoE layers) and internvl2-2b
(embeds + tokens), float32, the reference's tree carried over, a prefill
of S = 64 positions and 2 greedy decode steps: logits within 1e-4 +
1e-3|x| and identical tokens, as ``test_other_dense_configs_match``.
Hubert's ``make_encode_step`` on ``attn_impl="flash"`` (non-causal at an
S that is not a multiple of the kernel's block) against the reference's
on ``"full"`` (its flash route lets padded keys into a non-causal softmax,
ROADMAP.md §3): every position's logits within 1e-4 + 1e-3|x|.

The reference's decode without a sliding window writes each new key at
slot clip(cache_pos, 0, T - 1) of a prefill cache of T = S slots, so
from the second step on it overwrites the key before it (ROADMAP.md §3).
The port keeps that cache on purpose;
``test_reference_decode_drops_a_key_without_a_window`` pins it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch.steps import make_decode_step as j_decode_step
from repro.launch.steps import make_encode_step as j_encode_step
from repro.launch.steps import make_prefill_step as j_prefill_step
from repro.models import model as j_model
from repro.sharding.rules import ShardingContext as JCtx
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.steps import (make_decode_step, make_encode_step,
                                      make_prefill_step)
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.sharding.rules import ShardingContext

from _torch_parity import np_

SEQ, BATCH = 32, 2
TOL = dict(atol=1e-4, rtol=1e-3)


def make_batch(cfg, rng, S=SEQ, B=BATCH, dtype=np.float32):
    """numpy {embeds, tokens} as the reference's make_batch lays them out:
    the vision stub's patch positions before the text, every position
    from the audio stub."""
    n_front = S if cfg.frontend == "audio" else cfg.frontend_positions
    batch = {}
    if cfg.frontend:
        batch["embeds"] = rng.normal(size=(B, n_front, cfg.d_model)).astype(
            dtype)
    if S - n_front > 0:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S - n_front)
                                       ).astype(np.int32)
    return batch


def _port_batch(batch, dtype):
    return {k: torch.as_tensor(v).to(dtype) if k == "embeds"
            else torch.as_tensor(v).long() for k, v in batch.items()}


@pytest.fixture(scope="module")
def arch_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = reduced(get_config(arch), seq=SEQ)
            cache[arch] = (cfg, model_lib.init_params(
                cfg, torch.Generator().manual_seed(0), "cpu"))
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", list_archs())
def test_forward_shapes(arch, arch_params):
    cfg, params = arch_params(arch)
    batch = _port_batch(make_batch(cfg, np.random.default_rng(2)),
                        torch.bfloat16)
    logits, caches = make_prefill_step(cfg)(params, batch)
    assert logits.shape == (BATCH, 1, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())
    if cfg.is_encoder_only:
        return
    assert caches is not None


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if not get_config(a).is_encoder_only])
def test_prefill_then_decode(arch, arch_params):
    """Decode consumes the prefill cache and emits finite logits; the
    caches keep their shapes."""
    cfg, params = arch_params(arch)
    batch = _port_batch(make_batch(cfg, np.random.default_rng(3)),
                        torch.bfloat16)
    _, caches = make_prefill_step(cfg)(params, batch)
    shapes = {n: [tuple(t.shape) for t in c] for n, c in caches.items()}
    step = {"token": torch.ones((BATCH, 1), dtype=torch.long),
            "cache_pos": SEQ}
    logits, new_caches = make_decode_step(cfg)(params, step, caches)
    assert logits.shape == (BATCH, 1, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())
    assert {n: [tuple(t.shape) for t in c]
            for n, c in new_caches.items()} == shapes


# -- the port against the reference -----------------------------------------

S = 64


def _serve_reference(arch, attn_impl, steps, S=S):
    """The reference's float32 prefill + greedy decode: (its tree as
    numpy, the numpy batch, [logits], [tokens fed])."""
    jcfg = j_reduced(j_get_config(arch), seq=S)
    params = j_model.init_params(jcfg, jax.random.key(0), jnp.float32)
    batch = make_batch(jcfg, np.random.default_rng(7), S)
    prefill = jax.jit(j_prefill_step(jcfg, JCtx(None, attn_impl=attn_impl)))
    decode = jax.jit(j_decode_step(jcfg, JCtx(None)))
    logits, caches = prefill(params, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    out, fed = [np.asarray(logits)], []
    for i in range(steps):
        tok = np.asarray(jnp.argmax(logits[:, -1], -1))[:, None]
        fed.append(tok.astype(np.int32))
        logits, caches = decode(params, {"token": jnp.asarray(fed[-1]),
                                         "cache_pos": jnp.asarray(S + i)},
                                caches)
        out.append(np.asarray(logits))
    return jax.tree.map(np.asarray, params), batch, out, fed


def _serve_port(arch, tree, batch, steps, attn_impl, S=S):
    cfg = reduced(get_config(arch), seq=S)
    params = lm_params_from_numpy(tree, cfg, "cpu")
    ctx = ShardingContext(attn_impl=attn_impl)
    logits, caches = make_prefill_step(cfg, ctx)(
        params, _port_batch(batch, torch.float32))
    out, toks = [np_(logits)], []
    for i in range(steps):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        toks.append(np_(tok))
        logits, caches = make_decode_step(cfg, ctx)(
            params, {"token": tok, "cache_pos": S + i}, caches)
        out.append(np_(logits))
    return cfg, params, out, toks


@pytest.mark.parametrize("arch,attn_impl", [
    ("granite-moe-1b-a400m", "auto"), ("granite-moe-1b-a400m", "flash"),
    ("qwen3-moe-235b-a22b", "auto"), ("jamba-1.5-large-398b", "auto"),
    ("internvl2-2b", "auto"), ("internvl2-2b", "flash")])
def test_moe_and_frontend_archs_match(arch, attn_impl):
    """float32 prefill (S = 64) and 2 greedy decode steps."""
    tree, batch, want, fed = _serve_reference(arch, attn_impl, 2)
    cfg, _, got, toks = _serve_port(arch, tree, batch, 2, attn_impl)
    if arch.startswith("jamba"):
        assert {m for m, _ in model_lib.blocks.group_plan(cfg)} == {
            "attn", "ssm"} and any(f == "moe" for _, f in
                                   model_lib.blocks.group_plan(cfg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    for g, w in zip(toks, fed):
        np.testing.assert_array_equal(g, w)


def test_hubert_encode_on_flash_matches_the_reference_full():
    """S = 50 frame embeddings: not a multiple of the kernel's block, so
    the key-length mask decides the non-causal softmax."""
    arch, S_enc = "hubert-xlarge", 50
    jcfg = j_reduced(j_get_config(arch), seq=S_enc)
    params = j_model.init_params(jcfg, jax.random.key(1), jnp.float32)
    batch = make_batch(jcfg, np.random.default_rng(8), S_enc)
    assert set(batch) == {"embeds"} and not jcfg.attention.causal
    want = np.asarray(jax.jit(j_encode_step(jcfg, JCtx(
        None, attn_impl="full")))(params, {k: jnp.asarray(v)
                                           for k, v in batch.items()}))
    cfg = reduced(get_config(arch), seq=S_enc)
    got = make_encode_step(cfg, ShardingContext(attn_impl="flash"))(
        lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu"),
        _port_batch(batch, torch.float32))
    assert got.shape == (BATCH, S_enc, cfg.vocab)
    np.testing.assert_allclose(np_(got), want, **TOL)


def test_reference_decode_drops_a_key_without_a_window():
    """Reduced granite-moe (no window): the port and the reference agree
    at both decode steps; step 1 matches a dense oracle (the port's
    prefill over the prompt and the first fed token: capacity "full"
    routes each token alone, so it is what a decode that keeps every
    key gives), step 2 does not: slot S - 1 then holds token S's key,
    and prompt token S - 1's is gone."""
    arch = "granite-moe-1b-a400m"
    tree, batch, want, fed = _serve_reference(arch, "auto", 2)
    cfg, params, got, toks = _serve_port(arch, tree, batch, 2, "auto")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert cfg.attention.sliding_window is None
    prefill = make_prefill_step(cfg)
    prompt = torch.as_tensor(batch["tokens"]).long()
    for step in (1, 2):
        seq = torch.cat([prompt] + [torch.as_tensor(t).long()
                                    for t in fed[:step]], dim=1)
        oracle = np_(prefill(params, {"tokens": seq})[0])
        gap = np.abs(got[step] - oracle).max()
        if step == 1:
            np.testing.assert_allclose(got[1], oracle, **TOL)
        else:
            assert gap > 100 * TOL["atol"], gap
            assert np.abs(want[2] - oracle).max() > 100 * TOL["atol"]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-2b"])
def test_params_carry_the_moe_and_frontend_leaves(arch):
    """A bf16 reference tree carries over leaf by leaf, dtypes kept (the
    router stays float32); ``init_params(device="meta")`` builds the
    same leaves at full size."""
    jcfg = j_reduced(j_get_config(arch), seq=S)
    tree = jax.tree.map(np.asarray, j_model.init_params(
        jcfg, jax.random.key(2), jnp.bfloat16))
    params = lm_params_from_numpy(tree, reduced(get_config(arch), seq=S),
                                  "cpu")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(adamw.tree_leaves(params))
    for path, want in flat:
        got = params
        for key in path:
            got = got[key.key]
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, path
        np.testing.assert_array_equal(np_(got.float()),
                                      want.astype(np.float32))
    full = get_config(arch)
    meta = model_lib.init_params(full, torch.Generator(), device="meta",
                                 dtype=torch.bfloat16)
    if full.moe is not None:
        moe_p = meta["groups"]["layer0"]["moe"]
        E, f = full.moe.num_experts, full.moe.d_ff_expert
        assert moe_p["router"].dtype == torch.float32
        assert moe_p["router"].shape == (full.n_layers, full.d_model, E)
        assert moe_p["w_in"].shape == (full.n_layers, E, full.d_model, f)
        assert params["groups"]["layer0"]["moe"]["router"].dtype == \
            torch.float32
    else:
        assert meta["frontend"]["proj"].shape == (full.d_model, full.d_model)
        assert "frontend" in params
