"""Port filter models and scene generators against the JAX package: the
model constants are exactly equal, the EKF dynamics agree in float32,
and the seeded scenes are the same arrays."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import filters as jf
from repro.data import trajectories as jt
from repro_torch.core import filters as tf
from repro_torch.data import trajectories as tt

from _torch_parity import np_, t32

BUILDERS = {
    "lkf": lambda f: f.make_cv_lkf(),
    "ekf": lambda f: f.make_ctra_ekf(),
    "cv9": lambda f: f.make_cv9_lkf(),
    "ca9": lambda f: f.make_ca9_lkf(),
    "ct9+": lambda f: f.make_ct9_lkf(0.7),
    "ct9-": lambda f: f.make_ct9_lkf(-0.7),
    "lkf-dt": lambda f: f.make_cv_lkf(dt=0.1, q=0.3, r=0.05, p0=2.0),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_model_constants_identical(name):
    a, b = BUILDERS[name](jf), BUILDERS[name](tf)
    for f in ("F", "H", "Q", "R", "x0", "P0"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    assert (b.name, b.n, b.m, b.is_linear, b.dt) == \
        (a.name, a.n, a.m, a.is_linear, a.dt)


@pytest.mark.parametrize("kind", ["lkf", "ekf", "cv9", "ca9"])
def test_get_filter_identical(kind):
    a, b = jf.get_filter(kind), tf.get_filter(kind)
    for f in ("F", "H", "Q", "R", "x0", "P0"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def test_imm_model_identical():
    a, b = jf.make_imm(), tf.make_imm()
    np.testing.assert_array_equal(b.trans, a.trans)
    np.testing.assert_array_equal(b.mu0, a.mu0)
    assert [m.name for m in b.models] == [m.name for m in a.models]
    for ma, mb in zip(a.models, b.models):
        for f in ("F", "H", "Q", "R", "x0", "P0"):
            np.testing.assert_array_equal(getattr(mb, f), getattr(ma, f))
    one = tf.as_imm(tf.get_filter("ekf"))
    assert one.K == 1 and one.trans.tolist() == [[1.0]]
    assert tf.as_imm(b) is b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ekf_dynamics_match(seed):
    a, b = jf.make_ctra_ekf(), tf.make_ctra_ekf()
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, 8)).astype(np.float32) * 3
    np.testing.assert_allclose(np_(b.f(t32(x))), np.asarray(a.f(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(np_(b.F_jac(t32(x))),
                               np.asarray(a.F_jac(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(np_(b.predict_mean(t32(x))),
                               np.asarray(a.predict_mean(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_array_equal(b.f_np(x[0]), a.f_np(x[0]))
    np.testing.assert_array_equal(b.F_jac_np(x[0]), a.F_jac_np(x[0]))


@pytest.mark.parametrize("kind,seed", [("lkf", 0), ("ekf", 5), ("cv9", 11)])
def test_mot_scene_identical(kind, seed):
    cfg_j = jt.SceneConfig(T=40, max_targets=6, clutter_rate=2.0, max_meas=16)
    cfg_t = tt.SceneConfig(T=40, max_targets=6, clutter_rate=2.0, max_meas=16)
    za, va, ta = jt.mot_scene(jf.get_filter(kind), cfg_j, seed=seed)
    zb, vb, tb = tt.mot_scene(tf.get_filter(kind), cfg_t, seed=seed)
    np.testing.assert_array_equal(zb, za)
    np.testing.assert_array_equal(vb, va)
    assert [[i for i, _ in f] for f in tb] == [[i for i, _ in f] for f in ta]


@pytest.mark.parametrize("seed", [0, 7])
def test_maneuvering_and_single_target_identical(seed):
    for a, b in zip(jt.maneuvering_target(90, seed=seed),
                    tt.maneuvering_target(90, seed=seed)):
        np.testing.assert_array_equal(b, a)
    for kind in ("lkf", "ekf"):
        for a, b in zip(jt.single_target(jf.get_filter(kind), 30, seed=seed),
                        tt.single_target(tf.get_filter(kind), 30, seed=seed)):
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("kind", ["lkf", "imm"])
def test_device_constants_live_as_long_as_their_model(kind):
    """A model's cached constants (``device_const``, the kernels' packed
    table) are made once, reused, and dropped with the model."""
    import gc
    import weakref

    import torch
    from repro_torch.kernels.katana_bank import ops

    model = tf.make_imm() if kind == "imm" else tf.get_filter(kind)
    first = (tf.device_const(model, "x", lambda: np.eye(3), torch.float32,
                             "cpu"), ops._consts(model, "cpu"))
    again = (tf.device_const(model, "x", np.zeros(3), torch.float32, "cpu"),
             ops._consts(model, "cpu"))
    assert all(a is b for a, b in zip(first, again))
    np.testing.assert_array_equal(first[1].numpy(), ops._host_consts(model))
    gone = weakref.ref(model)
    del model
    gc.collect()
    assert gone() is None
