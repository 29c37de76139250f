"""The port's ssd_scan op (its plain version on the CPU) against the JAX
package: the Pallas op in interpret mode (``repro.kernels.ssd_scan.ops.
ssd_scan``, as tests/test_kernels.py runs it), the sequential oracle
``ssd_naive`` and ``repro.models.ssm.ssd_chunked`` (y and the final
state), and the port's own copy of ``ssd_naive``. Float32 within atol
1e-4 / rtol 1e-3, the reference's own tolerance; bfloat16 against the
Pallas op within one bf16 ulp (both do float32 inside and round once;
values under 2^-6 judged at 2^-6). Chunks 16, 32 and 64, S < chunk,
state0, and decays that would overflow above the diagonal. The plain
version that rounds as the bf16 tensor-core kernels do
(``ref.ssd_scan_hilo_plain``) against the Pallas op and the float32
plain version (y within one bf16 ulp, the state within 1e-4 of its
scale)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as j_scan
from repro.kernels.ssd_scan.ref import ssd_naive as j_naive
from repro.models.ssm import ssd_chunked as j_chunked
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.models import ssm

from _torch_parity import np_

TOL = dict(atol=1e-4, rtol=1e-3)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B=2, S=64, H=3, P=16, N=8, dt_scale=0.5, state=False):
    """numpy x, dt (softplus of a normal, times dt_scale), Bm, Cm, A (H,)
    negative, state0 (or None), all float32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    dt = (np.log1p(np.exp(f(B, S, H))) * dt_scale).astype(np.float32)
    A = -np.exp(f(H)).astype(np.float32)
    return (f(B, S, H, P), dt, f(B, S, N), f(B, S, N), A,
            f(B, H, P, N) if state else None)


def _jax(args, dtype="float32"):
    x, dt, Bm, Cm, A, s0 = args
    cast = lambda a: jnp.asarray(a, JNP[dtype])  # noqa: E731
    return (cast(x), jnp.asarray(dt), cast(Bm), cast(Cm), jnp.asarray(A),
            None if s0 is None else jnp.asarray(s0))


def _torch(args, dtype="float32"):
    x, dt, Bm, Cm, A, s0 = args
    cast = lambda a: torch.as_tensor(a).to(TORCH[dtype])  # noqa: E731
    return (cast(x), torch.as_tensor(dt), cast(Bm), cast(Cm),
            torch.as_tensor(A), None if s0 is None else torch.as_tensor(s0))


def _within_bf16_ulp(got, want):
    a, b = np.asarray(got, np.float32), np.asarray(want, np.float32)
    big = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -6)
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
    assert (np.abs(a - b) <= ulp).all(), np.abs(a - b).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_scan_matches_the_pallas_op(dtype, chunk):
    args = _inputs(chunk)
    want = j_scan(*_jax(args, dtype)[:5], chunk=chunk)
    ops.reset_launches()
    y, state = ops.ssd_scan(*_torch(args, dtype)[:5], chunk=chunk)
    assert ops.LAUNCHES["ssd_scan"] == 0  # the CPU runs the plain one
    assert y.dtype == TORCH[dtype] and state.dtype == torch.float32
    got = np_(y.float())
    if dtype == "float32":
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    else:
        _within_bf16_ulp(got, np.asarray(want, np.float32))


@pytest.mark.parametrize("S,chunk", [(64, 16), (96, 32), (128, 64),
                                     (24, 64)])
@pytest.mark.parametrize("state", [False, True])
def test_ssd_scan_matches_naive_and_chunked(S, chunk, state):
    """y and the final state against the reference's sequential oracle
    and its chunked function; S < chunk runs one chunk of S."""
    args = _inputs(S + chunk, S=S, state=state)
    y, st = ops.ssd_scan(*_torch(args)[:5], chunk=chunk,
                         state0=_torch(args)[5])
    yn, sn = j_naive(*_jax(args)[:5], state0=_jax(args)[5])
    yc, sc = j_chunked(*_jax(args)[:5], chunk, state0=_jax(args)[5])
    for want_y, want_s in ((yn, sn), (yc, sc)):
        np.testing.assert_allclose(np_(y), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(np_(st), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("state", [False, True])
def test_port_naive_matches_the_reference(state):
    args = _inputs(5, S=40, state=state)
    y, st = ref.ssd_naive(*_torch(args)[:5], state0=_torch(args)[5])
    yn, sn = j_naive(*_jax(args)[:5], state0=_jax(args)[5])
    np.testing.assert_allclose(np_(y), np.asarray(yn), **TOL)
    np.testing.assert_allclose(np_(st), np.asarray(sn), **TOL)
    yp, sp = ops.ssd_scan(*_torch(args)[:5], chunk=8, state0=_torch(args)[5])
    np.testing.assert_allclose(np_(yp), np_(y), **TOL)
    np.testing.assert_allclose(np_(sp), np_(st), **TOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_port_ssd_chunked_matches_the_reference(chunk):
    args = _inputs(chunk + 1, S=128, state=True)
    y, st = ssm.ssd_chunked(*_torch(args)[:5], chunk, _torch(args)[5])
    yc, sc = j_chunked(*_jax(args)[:5], chunk, state0=_jax(args)[5])
    np.testing.assert_allclose(np_(y), np.asarray(yc), **TOL)
    np.testing.assert_allclose(np_(st), np.asarray(sc), **TOL)


def test_large_decay_stays_finite():
    """dt A of about -40 a step: exp(cum_i - cum_j) above the diagonal
    would be exp of +2500; the plain version, like the kernel, never
    forms it. Held to the reference's chunked function and the Pallas
    op, which share the formulation: at |cum| ~ 2500 a float32 ulp of cum
    is 2.4e-4, which exp(cum_Q - cum_j) carries into the state, so the
    reference's own ``ssd_chunked`` parts from the sequential oracle by
    more than 1e-4 + 1e-3|x| there."""
    args = _inputs(9, S=128, dt_scale=20.0, state=True)
    assert float((args[1][..., None] * -args[4]).max()) > 40
    y, st = ops.ssd_scan(*_torch(args)[:5], chunk=64, state0=_torch(args)[5])
    assert bool(torch.isfinite(y).all() and torch.isfinite(st).all())
    yc, sc = j_chunked(*_jax(args)[:5], 64, state0=_jax(args)[5])
    np.testing.assert_allclose(np_(y), np.asarray(yc), **TOL)
    np.testing.assert_allclose(np_(st), np.asarray(sc), **TOL)
    args = args[:5] + (None,)
    y, _ = ops.ssd_scan(*_torch(args)[:5], chunk=64)
    np.testing.assert_allclose(np_(y), np.asarray(j_scan(*_jax(args)[:5],
                                                         chunk=64)), **TOL)


def test_unaligned_sequence_raises():
    """S not a multiple of Q = min(chunk, S): the reference asserts."""
    args = _torch(_inputs(1, S=48))
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_scan(*args[:5], chunk=32)
    with pytest.raises(AssertionError):
        j_chunked(*_jax(_inputs(1, S=48))[:5], 32)


def test_shapes_are_checked():
    x, dt, Bm, Cm, A, _ = _torch(_inputs(2))
    with pytest.raises(ValueError, match="need x"):
        ops.ssd_scan(x, dt[:, :, :2], Bm, Cm, A, chunk=16)
    with pytest.raises(ValueError, match="need x"):
        ops.ssd_scan(x, dt, Bm, Cm, A, chunk=16,
                     state0=torch.zeros(2, 3, 16, 4))


@pytest.mark.parametrize("P,N,Q,match", [(16, 24, 64, "d_state"),
                                         (16, 256, 64, "d_state"),
                                         (8, 16, 64, "head_dim"),
                                         (64, 128, 512, "chunk")])
def test_kernel_limits_raise(P, N, Q, match):
    """What the CUDA kernels do not take raises, naming the limit (a
    CUDA tensor never falls back to the plain version); the float32 and
    bf16 routes take the same shapes."""
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(NotImplementedError, match=match):
            ops.block_p(P, N, Q, dtype)


def test_unsupported_type_raises():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.block_p(64, 128, 256, torch.float16)


@pytest.mark.parametrize("P,want", [(64, 32), (128, 32), (16, 16),
                                    (48, 16)])
def test_block_width(P, want):
    """float32: the CUDA-core kernel's state columns a block, 32 where P
    allows (the default type)."""
    assert ops.block_p(P, 128, 256) == want
    assert ops.block_p(P, 128, 256, torch.float32) == want


@pytest.mark.parametrize("P,want", [(64, 64), (128, 64), (16, 16),
                                    (48, 16), (96, 32)])
def test_block_width_bf16(P, want):
    """bf16: the tensor-core output pass's columns of p, the widest of
    64, 32 and 16 that divides P."""
    assert ops.block_p(P, 128, 256, torch.bfloat16) == want


def test_hilo_carries_float32_to_16_bits():
    t = torch.as_tensor(np.random.default_rng(3).normal(size=4096) * 1e3,
                        dtype=torch.float32)
    err = (ref.hilo(t) - t).abs() / t.abs()
    assert float(err.max()) <= 2.0 ** -16


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_hilo_plain_matches_the_pallas_op_and_plain(chunk):
    """bf16 inputs: y of the hi + lo plain version within one bf16 ulp of
    the Pallas op (interpret mode) and of the float32 plain version; the
    final state within 1e-4 of its scale of the plain version's."""
    args = _torch(_inputs(chunk + 7, S=128, P=32, N=16), "bfloat16")
    y, st = ref.ssd_scan_hilo_plain(*args[:5], chunk)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    want = j_scan(*_jax(_inputs(chunk + 7, S=128, P=32, N=16),
                        "bfloat16")[:5], chunk=chunk)
    _within_bf16_ulp(np_(y.float()), np.asarray(want, np.float32))
    y_p, st_p = ref.ssd_scan_plain(*args[:5], chunk)
    _within_bf16_ulp(np_(y.float()), np_(y_p.float()))
    assert float((st - st_p).abs().max()) <= 1e-4 * float(st_p.abs().max())


@pytest.mark.parametrize("S,chunk", [(64, 16), (24, 64)])
def test_hilo_plain_with_state0_matches_chunked(S, chunk):
    """state0 and S < chunk: y and the final state of the hi + lo plain
    version (float32 inputs, so only the hi + lo rounding differs) against
    the reference's ssd_chunked within its own tolerance."""
    args = _inputs(S + 3, S=S, state=True)
    y, st = ref.ssd_scan_hilo_plain(*_torch(args)[:5], chunk, _torch(args)[5])
    yc, sc = j_chunked(*_jax(args)[:5], chunk, state0=_jax(args)[5])
    np.testing.assert_allclose(np_(y), np.asarray(yc), **TOL)
    np.testing.assert_allclose(np_(st), np.asarray(sc), **TOL)
