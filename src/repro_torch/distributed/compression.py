"""int8 error-feedback gradient compression.

A port of ``repro/distributed/compression.py``'s ``ef_compress``: the
error-feedback quantize / dequantize round trip applied to the gradient
tree before the optimizer. Numerically it is what a compressed
data-parallel all-reduce delivers; the residual (``ef``) carries the
quantization error into the next step, so the estimate stays unbiased
in the long run. The reference's ``compressed_psum`` (an int8 ring
all-reduce over a mesh axis) needs a process group and is not ported
yet.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_map


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and the per-tensor float32 scale max|g| / 127."""
    g32 = g.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(grads: Any, ef: Any) -> Tuple[Any, Any]:
    """Error-feedback int8 round trip on a gradient tree.

    Returns (dequantized grads, new error residuals)."""
    def leaf(g, e):
        g32 = g.to(torch.float32) + e
        deq = _dequantize(*_quantize(g32))
        return deq, g32 - deq

    out = tree_map(leaf, grads, ef)
    # the pairs sit at grads' leaves: split them along grads' structure
    return (tree_map(lambda _, o: o[0], grads, out),
            tree_map(lambda _, o: o[1], grads, out))
