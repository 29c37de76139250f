"""Shared helpers of the ``test_torch_*`` files: the same numpy inputs go
to the JAX package (the reference) and to the PyTorch port, and the
results come back as numpy arrays for comparison."""
from __future__ import annotations

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
