"""int8 error-feedback gradient compression.

A port of ``repro/distributed/compression.py``'s ``ef_compress``: the
error-feedback quantize / dequantize round trip applied to the gradient
tree before the optimizer. Numerically it is what a compressed
data-parallel all-reduce delivers; the residual (``ef``) carries the
quantization error into the next step, so the estimate stays unbiased
in the long run.

``compressed_psum`` is the reference's int8 ring all-reduce over a mesh
axis: one max of |x| over the axis gives the shared scale, and P - 1
hops of the int8 codes around the ring (``collectives.permute``) add up
in float32. The codes are integers and their sums stay exact in float32
(|sum| <= 127 P), so the result equals the reference's bit for bit.
It is not wired into the train step, as the reference's is not.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.optim.adamw import tree_map


def _quantize(g: torch.Tensor, gmax=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and the per-tensor float32 scale max|g| / 127 (``gmax``
    the max |g| where it is taken over more than ``g``)."""
    g32 = g.to(torch.float32)
    if gmax is None:
        gmax = torch.max(torch.abs(g32))
    scale = torch.clamp(gmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(grads: Any, ef: Any, ctx=None, specs=None
                ) -> Tuple[Any, Any]:
    """Error-feedback int8 round trip on a gradient tree.

    On a mesh (``ctx``, and ``specs`` the spec tree of the leaves) each
    leaf is this rank's block, and its scale comes from the max over the
    full logical tensor (a max over the axes the leaf is split on), as
    the reference's global arrays give it.

    Returns (dequantized grads, new error residuals)."""
    from repro_torch.sharding import rules

    mesh = ctx is not None and ctx.mesh is not None
    boxes = (rules.map_specs(_Box, specs, is_leaf=rules.is_spec) if mesh
             else tree_map(lambda _: _Box(()), grads))

    def leaf(g, e, box):
        g32 = g.to(torch.float32) + e
        gmax = torch.max(torch.abs(g32))
        axes = rules.spec_axes(box.spec)
        if axes:
            gmax = coll.all_reduce(gmax, ctx.mesh,
                                   coll.mesh_order(ctx.mesh, axes), op="max")
        deq = _dequantize(*_quantize(g32, gmax))
        return deq, g32 - deq

    out = tree_map(leaf, grads, ef, boxes)
    # the pairs sit at grads' leaves: split them along grads' structure
    return (tree_map(lambda _, o: o[0], grads, out),
            tree_map(lambda _, o: o[1], grads, out))


class _Box:
    """A spec as one leaf of ``tree_map`` (which walks into tuples)."""

    def __init__(self, spec):
        self.spec = spec


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the mesh ``axis`` with an int8 wire payload:
    the scale max(max |x| over the axis, 1e-12) / 127, int8 codes by
    round-half-even, P - 1 ring hops of the codes each added in float32,
    the sum times the scale. Every rank of the axis calls it."""
    P = coll.size(mesh, axis)
    x32 = x.to(torch.float32)
    smax = coll.all_reduce(torch.max(torch.abs(x32)), mesh, axis, op="max")
    smax = torch.clamp(smax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / smax), -127, 127).to(torch.int8)
    acc = q.to(torch.float32)
    buf = q
    for _ in range(P - 1):
        buf = coll.permute(buf, mesh, axis)
        acc = acc + buf.to(torch.float32)
    return acc * smax

