"""The shape-only trees: ``models.model.abstract_params`` and
``optim.adamw.abstract_train_state`` (``meta`` tensors) have the leaves,
shapes and dtypes of the reference's ``jax.eval_shape`` trees on every
arch, in the reference's layout (the one ``convert.lm_params_from_numpy``
copies leaf for leaf), and allocate nothing."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as tadamw

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int32": torch.int32}


@functools.lru_cache(maxsize=None)
def jax_abstract_params(arch, dtype=None):
    return jmodel.abstract_params(jget_config(arch),
                                  jnp.dtype(dtype) if dtype else None)


def flat(tree, path=""):
    """{path: leaf} of a dict tree (None leaves dropped)."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(flat(tree[k], f"{path}/{k}"))
        return out
    return {} if tree is None else {path: tree}


def assert_same_leaves(got, want):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].device.type == "meta", k
        assert tuple(g[k].shape) == tuple(w[k].shape), k
        assert g[k].dtype == TORCH_DTYPES[jnp.dtype(w[k].dtype).name], k


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("dtype", [None, "float32"])
def test_abstract_params_match_eval_shape(arch, dtype):
    want = jax_abstract_params(arch, dtype)
    got = tmodel.abstract_params(get_config(arch),
                                 TORCH_DTYPES[dtype] if dtype else None)
    assert_same_leaves(got, want)


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("compression", [False, True])
def test_abstract_train_state_matches_eval_shape(arch, compression):
    want = jadamw.abstract_train_state(jax_abstract_params(arch),
                                       compression)
    got = tadamw.abstract_train_state(
        tmodel.abstract_params(get_config(arch)), compression)
    assert tuple(got.step.shape) == tuple(want.step.shape) == ()
    assert got.step.dtype == torch.int32 and got.step.device.type == "meta"
    for field in ("master", "m", "v", "ef"):
        w = getattr(want, field)
        if w is None:
            assert getattr(got, field) is None
            continue
        assert_same_leaves(getattr(got, field), w)


def test_abstract_tree_is_what_convert_fills():
    """A reduced reference tree converts leaf for leaf onto the abstract
    tree's shapes and dtypes; a real parameter tree turns into a meta
    train state without copying it."""
    arch = "granite-moe-1b-a400m"
    cfg = reduced(get_config(arch))
    from repro.configs import reduced as jreduced

    jtree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                         jmodel.abstract_params(jreduced(jget_config(arch))))
    params = convert.lm_params_from_numpy(jtree, cfg, device="cpu")
    abstract = flat(tmodel.abstract_params(cfg))
    real = flat(params)
    assert sorted(real) == sorted(abstract)
    for k, t in real.items():
        assert (t.shape, t.dtype) == (abstract[k].shape, abstract[k].dtype), k
    state = tadamw.abstract_train_state(params)
    assert all(t.device.type == "meta"
               for t in flat(state.master).values())
    assert all(t.device.type == "cpu" for t in real.values())
