"""Shared helpers of the ``test_torch_*`` files: the same numpy inputs go
to the JAX package (the reference) and to the PyTorch port, and the
results come back as numpy arrays for comparison."""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro.core import filters as jf
from repro_torch.core import filters as tf

KINDS = ("lkf", "ekf", "imm")


def models(kind: str):
    """(jax model, port model, scene model of the port, scene model of
    the reference) for a workload name."""
    if kind == "imm":
        return jf.make_imm(), tf.make_imm(), tf.get_filter("cv9"), \
            jf.get_filter("cv9")
    return jf.get_filter(kind), tf.get_filter(kind), tf.get_filter(kind), \
        jf.get_filter(kind)


def t32(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def np_(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


JITTED_STATE_TOL = 1e-5  # of max(1, |reference state|)


def assert_jitted_frame(rt, rj, imm):
    """A port FrameResult ``rt`` against the reference's ``rj``: assoc,
    unassigned, confirmed and the lifecycle identical, the states within
    ``JITTED_STATE_TOL`` of max(1, |reference|)."""
    for f in ("assoc", "unassigned", "confirmed"):
        np.testing.assert_array_equal(np_(getattr(rt, f)),
                                      np_(getattr(rj, f)), err_msg=f)
    for f in ("track_id", "active", "hits", "misses", "age", "next_id"):
        np.testing.assert_array_equal(np_(getattr(rt.bank, f)),
                                      np_(getattr(rj.bank, f)), err_msg=f)
    fields = [("x", rt.bank.x, rj.bank.x), ("P", rt.bank.P, rj.bank.P)]
    if imm:
        fields += [("mu", rt.bank.mu, rj.bank.mu),
                   ("x_est", rt.x_est, rj.x_est),
                   ("mode_probs", rt.mode_probs, rj.mode_probs)]
    for name, a, b in fields:
        a, b = np_(a), np_(b)
        err = np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)), initial=0)
        assert err <= JITTED_STATE_TOL, (name, err)


def run_jitted_both(jstep, jbank, tstep, tbank, frames, imm):
    """Drive both trackers over ``frames`` [(z, valid)] numpy; returns the
    last (port, reference) results."""
    for z, v in frames:
        rj = jstep(jbank, jax.numpy.asarray(z, np.float32),
                   jax.numpy.asarray(v))
        rt = tstep(tbank, torch.as_tensor(z, dtype=torch.float32),
                   torch.as_tensor(v))
        assert_jitted_frame(rt, rj, imm)
        jbank, tbank = rj.bank, rt.bank
    return rt, rj
