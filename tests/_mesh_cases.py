"""Settings shared by ``tests/test_torch_mesh.py``, its port worker
(``_torch_mesh_worker.py``) and its reference (``_jax_mesh_reference.py``):
the cases, and flat numpy trees keyed by '/'-joined paths. Imports
neither torch nor jax."""
from __future__ import annotations

from typing import Dict

import numpy as np

WORLD = 4
# apply_moe: experts over model (2), the FFN dim (8) over data (2)
MOE_CFG = dict(num_experts=4, top_k=2, d_ff_expert=8, period=1)
MOE_D, MOE_X = 16, (4, 64, 16)
MOE_CASES = [(mode, act, cap) for mode in ("gather", "tp2d")
             for act in ("swiglu", "squared_relu")
             for cap in ("full", "factor")]
# (arch, batch, moe mode): granite-moe (MoE, GQA 4 / 4 heads, the vocab
# split over model), granite-20b (MQA: kv replicated; a tensor-parallel
# MLP; learned positions), and a batch of 1 that does not divide the data
# axes (the cache's sequence over data + model)
LM_CASES = [("granite-moe-1b-a400m", 4, "gather"),
            ("granite-moe-1b-a400m", 4, "tp2d"),
            ("granite-20b", 4, "gather"),
            ("granite-20b", 1, "gather")]
# the same, for the SSM mixer: reduced mamba2 (H = 8 heads of 16 over
# model) and jamba (Mamba-2, attention and MoE layers), both batches; and
# the vision frontend: internvl2 (8 patch embeddings before the tokens,
# the projection FSDP-split)
SSM_FRONTEND_CASES = [("mamba2-130m", 4, "gather"),
                      ("mamba2-130m", 1, "gather"),
                      ("jamba-1.5-large-398b", 4, "gather"),
                      ("jamba-1.5-large-398b", 1, "gather"),
                      ("internvl2-2b", 4, "gather")]
LM_REDUCE = dict(n_layers=2, d_model=64, vocab=64, seq=16)
PROMPT = 16
DECODE_STEPS = 4
# reduced mamba2 at d 48: H = 6 heads, which a model axis of 4 does not
# divide, so every SSM leaf is replicated (logical_to_spec degrades it)
HEADS_REPLICATED = dict(arch="mamba2-130m", B=4, mesh=(1, 4), d_model=48)
# the audio frontend: reduced hubert's make_encode_step, every position
ENCODE_ARCH, ENCODE_B = "hubert-xlarge", 4
# (arch, steps): float32 training on (2, 2) from one start, as TRAIN_LEGS'
# first leg: the SSM leaves, the hybrid's MoE and the vision projection
TRAIN_CASES = [("mamba2-130m", 3), ("jamba-1.5-large-398b", 3),
               ("internvl2-2b", 2)]
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_RUN = dict(microbatches=2, remat="none", learning_rate=1e-3,
                 warmup_steps=2, total_steps=10)
TRAIN_BATCH = 4   # rows a microbatch
# (leg, mesh, steps): 3 steps on (2, 2), then from its checkpoint 2 steps
# on (4, 1) and, again from it, 2 on (1, 4)
TRAIN_LEGS = [("a", (2, 2), 3), ("b", (4, 1), 2), ("c", (1, 4), 2)]
TRAIN_METRICS = ("loss", "grad_norm", "ce", "aux", "lr")
PSUM_X = (WORLD * 3, 1000)


def flat(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays as {'a/b/c': array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflat(arrays: Dict[str, np.ndarray], prefix: str) -> Dict:
    """The nested dict of the arrays whose keys start with ``prefix``."""
    out: Dict = {}
    for key, v in arrays.items():
        if not key.startswith(prefix):
            continue
        node = out
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out
