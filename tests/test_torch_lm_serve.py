"""The port's LM serving slice against the JAX package: the same
parameters (the reference's tree carried over by
``lm_params_from_numpy``) and prompts through ``make_prefill_step`` and
``make_decode_step``. Reduced h2o-danube-1.8b (kv heads 2, since
``reduced`` makes it MHA; window 32; S = 64) prefilled through
flash_attention then greedy-decoded for 8 steps: float32 logits within
1e-4/1e-3, identical tokens and equal caches, with the decode step on the
dense route and on flash_decode; bfloat16 within 2e-2 of the values'
scale. Then the other reduced dense configs; reduced mamba2-130m (2
layers, d 64, N 16, P 16, chunk 16) prefilled through ssd_scan and
greedy-decoded the same way (float32 logits within 1e-4/1e-3, identical
tokens, equal caches; bfloat16 within 2e-2 of the values' scale); and
what one card does not serve (a mesh). The MoE and frontend archs are
held to the reference in ``tests/test_torch_archs.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch.steps import make_decode_step as j_decode_step
from repro.launch.steps import make_prefill_step as j_prefill_step
from repro.models import model as j_model
from repro.sharding.rules import ShardingContext as JCtx
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.lm import LMDataPipeline
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import blocks
from repro_torch.models.model import forward, init_params
from repro_torch.sharding.rules import ShardingContext

from _torch_parity import np_

S, STEPS, B = 64, 8, 2
TOL = dict(atol=1e-4, rtol=1e-3)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _danube(get, red):
    cfg = red(get("h2o-danube-1.8b"), seq=S)
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, n_kv_heads=2))


def _serve_reference(jcfg, dtype, attn_impl, steps):
    """The JAX package's prefill + greedy decode; returns the parameter
    tree (numpy), the prompts, [logits], [tokens fed] and [caches]."""
    params = j_model.init_params(jcfg, jax.random.key(0), JNP[dtype])
    prompts = LMDataPipeline(jcfg.vocab, S, B, seed=3).next_batch()["tokens"]
    prefill = jax.jit(j_prefill_step(jcfg, JCtx(None, attn_impl=attn_impl)))
    decode = jax.jit(j_decode_step(jcfg, JCtx(None)))
    logits, caches = prefill(params, {"tokens": jnp.asarray(prompts)})
    out_logits, fed, out_caches = [logits], [], [caches]
    for i in range(steps):
        tok = np.asarray(jnp.argmax(logits[:, -1], -1))[:, None]
        fed.append(tok.astype(np.int32))
        logits, caches = decode(params, {"token": jnp.asarray(fed[-1]),
                                         "cache_pos": jnp.asarray(S + i)},
                                caches)
        out_logits.append(logits)
        out_caches.append(caches)
    return (jax.tree.map(np.asarray, params), prompts,
            [np.asarray(x, np.float32) for x in out_logits], fed, out_caches)


@pytest.fixture(scope="module")
def danube_f32():
    return _serve_reference(_danube(j_get_config, j_reduced), "float32",
                            "flash", STEPS)


def _serve_port(cfg, tree, prompts, fed, attn_impl, decode_impl,
                greedy=True):
    """Prefill on ``attn_impl``, decode on ``decode_impl``'s route."""
    params = lm_params_from_numpy(tree, cfg, "cpu")
    prefill = make_prefill_step(cfg, ShardingContext(attn_impl=attn_impl))
    decode = make_decode_step(cfg, ShardingContext(attn_impl=decode_impl))
    logits, caches = prefill(params, {"tokens": torch.as_tensor(prompts)})
    out_logits, toks = [logits], []
    for i in range(len(fed)):
        tok = (logits[:, -1].argmax(-1, keepdim=True) if greedy
               else torch.as_tensor(fed[i]).long())
        toks.append(np_(tok))
        logits, caches = decode(params, {"token": tok, "cache_pos": S + i},
                                caches)
        out_logits.append(logits)
    return [np_(x.float()) for x in out_logits], toks, caches


@pytest.mark.parametrize("decode_impl", ["full", "flash"])
def test_danube_prefill_and_greedy_decode_match(danube_f32, decode_impl):
    tree, prompts, want_logits, want_toks, want_caches = danube_f32
    cfg = _danube(get_config, reduced)
    logits, toks, caches = _serve_port(cfg, tree, prompts, want_toks,
                                       "flash", decode_impl)
    for got, want in zip(logits, want_logits):
        np.testing.assert_allclose(got, want, **TOL)
    for got, want in zip(toks, want_toks):
        np.testing.assert_array_equal(got, want)
    for name, c in want_caches[-1].items():
        np.testing.assert_allclose(np_(caches[name].k), np.asarray(c.k),
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(np_(caches[name].v), np.asarray(c.v),
                                   atol=1e-5, rtol=1e-4)


def test_danube_prefill_cache_is_cut_to_the_window(danube_f32):
    tree, prompts, _, _, want_caches = danube_f32
    cfg = _danube(get_config, reduced)
    params = lm_params_from_numpy(tree, cfg, "cpu")
    _, caches = make_prefill_step(cfg, ShardingContext(attn_impl="flash"))(
        params, {"tokens": torch.as_tensor(prompts)})
    W = cfg.attention.sliding_window
    assert W == 32 and caches["layer0"].k.shape == (
        cfg.n_layers, B, W, 2, cfg.attention.head_dim)
    for name, c in want_caches[0].items():
        np.testing.assert_allclose(np_(caches[name].k), np.asarray(c.k),
                                   atol=1e-5, rtol=1e-4)


def _close_to_scale(got, want, tol):
    """max |got - want| <= tol * max |want|: bf16 rounds at other places
    in the two frameworks (a sigmoid or a product rounded apart or
    together), and the reference's own flash and full routes part by 1%
    of the logits' scale (0.031 at max |logit| 3.17), more than 2e-2 of
    a small logit."""
    want = np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_danube_bfloat16_matches():
    """bf16 parameters and activations, both sides fed the reference's
    greedy tokens: logits and caches within 2e-2 of their scale."""
    jcfg = _danube(j_get_config, j_reduced)
    tree, prompts, want_logits, fed, want_caches = _serve_reference(
        jcfg, "bfloat16", "flash", 3)
    cfg = _danube(get_config, reduced)
    logits, _, caches = _serve_port(cfg, tree, prompts, fed, "flash",
                                    "flash", greedy=False)
    assert caches["layer0"].k.dtype == torch.bfloat16
    for got, want in zip(logits, want_logits):
        _close_to_scale(got, want, 2e-2)
    for name, c in want_caches[-1].items():
        _close_to_scale(np_(caches[name].k.float()), c.k, 2e-2)
        _close_to_scale(np_(caches[name].v.float()), c.v, 2e-2)


@pytest.mark.parametrize("arch", ["command-r-35b", "granite-20b",
                                  "nemotron-4-15b"])
def test_other_dense_configs_match(arch):
    """layernorm + tied head (command-r), learned positions + qkv bias +
    gelu + MQA (granite-20b), squared-ReLU (nemotron): prefill on the
    auto route and two decode steps."""
    jcfg = j_reduced(j_get_config(arch), seq=S)
    tree, prompts, want_logits, fed, _ = _serve_reference(jcfg, "float32",
                                                          "auto", 2)
    logits, toks, _ = _serve_port(reduced(get_config(arch), seq=S), tree,
                                  prompts, fed, "auto", "auto")
    for got, want in zip(logits, want_logits):
        np.testing.assert_allclose(got, want, **TOL)
    for got, want in zip(toks, fed):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def mamba_f32():
    return _serve_reference(j_reduced(j_get_config("mamba2-130m"), seq=S),
                            "float32", "auto", STEPS)


def _assert_caches_equal(caches, want, **tol):
    for name, c in want.items():
        assert type(caches[name]).__name__ == type(c).__name__ == "SSMCache"
        for f, got, w in zip(c._fields, caches[name], c):
            assert tuple(got.shape) == w.shape, f
            np.testing.assert_allclose(np_(got.float()), np.asarray(
                w, np.float32), err_msg=f"{name}.{f}", **tol)


def test_mamba2_prefill_and_greedy_decode_match(mamba_f32):
    """Prefill through ssd_scan (its plain version here), 8 greedy decode
    steps on the one-step recurrence: logits, tokens and the caches after
    the prefill and after the last step."""
    tree, prompts, want_logits, want_toks, want_caches = mamba_f32
    cfg = reduced(get_config("mamba2-130m"), seq=S)
    assert (cfg.n_layers, cfg.d_model, cfg.ssm.d_state, cfg.ssm.head_dim,
            cfg.ssm.chunk) == (2, 64, 16, 16, 16)
    params = lm_params_from_numpy(tree, cfg, "cpu")
    _, caches0 = make_prefill_step(cfg)(
        params, {"tokens": torch.as_tensor(prompts)})
    _assert_caches_equal(caches0, want_caches[0], atol=1e-5, rtol=1e-4)
    logits, toks, caches = _serve_port(cfg, tree, prompts, want_toks, "auto",
                                       "auto")
    for got, want in zip(logits, want_logits):
        np.testing.assert_allclose(got, want, **TOL)
    for got, want in zip(toks, want_toks):
        np.testing.assert_array_equal(got, want)
    _assert_caches_equal(caches, want_caches[-1], atol=1e-5, rtol=1e-4)


def test_mamba2_bfloat16_matches():
    """bf16 parameters (A_log, D and dt_bias stay float32, as in the
    reference tree) and activations, both sides fed the reference's greedy
    tokens: logits and caches within 2e-2 of their scale."""
    jcfg = j_reduced(j_get_config("mamba2-130m"), seq=S)
    tree, prompts, want_logits, fed, want_caches = _serve_reference(
        jcfg, "bfloat16", "auto", 3)
    cfg = reduced(get_config("mamba2-130m"), seq=S)
    params = lm_params_from_numpy(tree, cfg, "cpu")
    ssm_p = params["groups"]["layer0"]["ssm"]
    for k in ("A_log", "D", "dt_bias"):
        assert ssm_p[k].dtype == torch.float32, k
    assert ssm_p["wx"].dtype == torch.bfloat16
    assert params["embed"]["tokens"].dtype == torch.bfloat16
    logits, _, caches = _serve_port(cfg, tree, prompts, fed, "auto", "auto",
                                    greedy=False)
    assert caches["layer0"].state.dtype == torch.float32
    assert caches["layer0"].conv_x.dtype == torch.bfloat16
    for got, want in zip(logits, want_logits):
        _close_to_scale(got, want, 2e-2)
    for name, c in want_caches[-1].items():
        for got, w in zip(caches[name], c):
            _close_to_scale(np_(got.float()), w, 2e-2)


def test_mamba2_init_shapes_and_caches():
    """The tied head serves vocab 50280 with no learned positions; the
    stacked caches take the float32 state and the model-dtype tails."""
    full = get_config("mamba2-130m")
    p = init_params(full, torch.Generator(), device="meta",
                    dtype=torch.bfloat16)
    assert "head" not in p and "positions" not in p["embed"]
    assert p["embed"]["tokens"].shape == (50280, 768)
    assert p["groups"]["layer0"]["ssm"]["wx"].shape == (24, 768, 24, 64)
    assert set(p["groups"]["layer0"]) == {"norm1", "ssm"}
    cfg = reduced(full, seq=S)
    caches = blocks.init_cache(cfg, 3, 100, "cpu", torch.bfloat16)
    c = caches["layer0"]
    assert c.state.shape == (2, 3, 8, 16, 16) and c.state.dtype == \
        torch.float32
    assert c.conv_x.shape == (2, 3, 3, 8, 16) and c.conv_x.dtype == \
        torch.bfloat16
    assert c.conv_B.shape == c.conv_C.shape == (2, 3, 3, 16)


def test_what_one_card_does_not_serve():
    cfg = _danube(get_config, reduced)
    # a mesh serves every arch: the SSM mixer's train step builds on the
    # reference's (4, 2) mesh (tests/test_sharding.py:53)
    from repro_torch.configs import RunConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.sharding.rules import AbstractMesh, make_context

    mesh_ctx = make_context(AbstractMesh((4, 2), ("data", "model")))
    assert callable(make_train_step(reduced(get_config("mamba2-130m")),
                                    RunConfig(), mesh_ctx))
    with pytest.raises(ValueError, match="attn_impl"):
        ShardingContext(attn_impl="xla")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    # training is served now (tests/test_torch_train.py); a mode that is
    # not one of train / prefill / decode raises
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long)}
    logits, caches = forward(params, cfg, batch, "train")
    assert logits.shape == (1, 4, cfg.vocab) and caches is None
    with pytest.raises(ValueError, match="mode"):
        forward(params, cfg, batch, "serve")
    tree = {k: v for k, v in params.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        lm_params_from_numpy(tree, cfg, "cpu")
    params["head"] = params["head"][:, :5]
    with pytest.raises(ValueError, match="head"):
        lm_params_from_numpy(params, cfg, "cpu")


def test_init_cache_and_params_shapes():
    cfg = _danube(get_config, reduced)
    caches = blocks.init_cache(cfg, 3, 100, "cpu", torch.bfloat16)
    a = cfg.attention
    assert caches["layer0"].k.shape == (cfg.n_layers, 3, a.sliding_window,
                                        a.n_kv_heads, a.head_dim)
    p = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert p["groups"]["layer0"]["attn"]["wq"].shape == (
        cfg.n_layers, cfg.d_model, a.n_heads, a.head_dim)
    assert p["head"].dtype == torch.bfloat16
