"""``examples/torch_serve_lm.py`` against the reference example's loop
(``examples/serve_lm.py``) on the reference's weights carried over by
``convert.lm_params_from_numpy``: the same greedy tokens in the configs'
own bfloat16, the port's prefill on ``flash_attention`` and its decode on
``flash_decode`` (their plain versions on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config, reduced
from repro.launch.steps import make_decode_step, make_prefill_step
from repro.models import model as model_lib
from repro_torch import convert

from _torch_examples import load_example

B, PROMPT, GEN = 2, 32, 8


def reference_tokens(cfg, params):
    """The reference example's prefill and greedy decode."""
    prefill = jax.jit(make_prefill_step(cfg))
    decode = jax.jit(make_decode_step(cfg))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, PROMPT))
    logits, caches = prefill(params, {"tokens": jnp.asarray(prompts,
                                                            jnp.int32)})
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out = [np.asarray(tok)[:, 0]]
    for i in range(GEN - 1):
        step = {"token": tok, "cache_pos": jnp.asarray(PROMPT + i, jnp.int32)}
        logits, caches = decode(params, step, caches)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok)[:, 0])
    return np.stack(out, axis=1)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-130m"])
def test_serve_lm_matches_reference(arch):
    ex = load_example("torch_serve_lm")
    jcfg = reduced(get_config(arch), n_layers=2, d_model=128, vocab=512,
                   seq=PROMPT)
    params = model_lib.init_params(jcfg, jax.random.key(0))
    want = reference_tokens(jcfg, params)
    cfg = ex.serve_config(arch, PROMPT)
    tparams = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, device="cpu")
    got = ex.run(cfg, B, PROMPT, GEN, device="cpu", params=tparams)
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["tokens"].shape == (B, GEN)


def test_serve_lm_refuses_an_encoder_only_arch():
    ex = load_example("torch_serve_lm")
    with pytest.raises(ValueError, match="encoder-only"):
        ex.run(ex.serve_config("hubert-xlarge", PROMPT), device="cpu")
