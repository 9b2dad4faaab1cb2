"""Parameter trees as one flat buffer in the JAX package's leaf order.

A parameter tree is a nested dict of tensors.  Its leaves are taken in
sorted-key order at every level — the order of ``jax.tree.leaves`` on the
same dict — so the port's flat wire buffer matches the JAX trainer's
``_flatten_rows`` element for element.  ``ParamLayout`` records that order
with each leaf's shape and dtype, and turns a flat row back into a tree.

The flat buffers are float32 whatever the leaves' dtypes.  The columns of a
narrower leaf (bfloat16, float16) hold values of that dtype:
``ParamLayout.round_`` rounds them through it wherever the JAX trainer's
result takes the leaf dtype, and ``views`` hands the model each leaf in its
own dtype.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

Tensor = torch.Tensor


def leaves_with_path(tree, prefix=()) -> list:
    """[(path tuple, leaf)] in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves_with_path(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def map_leaves(fn, tree):
    """The same nested dict with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def dtype_of(x) -> torch.dtype:
    """The torch dtype of a tensor, or of a numpy array (``bfloat16`` from
    ml_dtypes included)."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    dt = np.asarray(x).dtype
    if dt.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dt)).dtype


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """paths/shapes/dtypes of the leaves in wire order; offsets into the
    flat row."""

    paths: tuple
    shapes: tuple
    dtypes: tuple

    @classmethod
    def of(cls, tree, lead: int = 0) -> "ParamLayout":
        """Layout of a tree whose leaves carry `lead` leading batch dims
        (e.g. 1 for worker-stacked (W, ...) leaves)."""
        pl = leaves_with_path(tree)
        return cls(tuple(p for p, _ in pl),
                   tuple(tuple(x.shape[lead:]) for _, x in pl),
                   tuple(dtype_of(x) for _, x in pl))

    @property
    def sizes(self) -> tuple:
        return tuple(math.prod(s) for s in self.shapes)

    @property
    def size(self) -> int:
        return sum(self.sizes)

    def leaf_index(self, device=None) -> Tensor:
        """(D,) int32 position -> leaf map of the flat row (the JAX
        trainer's ``seg``): ``table.index_select(-1, idx)`` expands a
        (..., L) per-leaf table to per-position values."""
        leaves = torch.arange(len(self.shapes), dtype=torch.int32,
                              device=device)
        return torch.repeat_interleave(
            leaves, torch.tensor(self.sizes, device=device),
            output_size=self.size)

    def split(self, flat: Tensor) -> tuple:
        """(..., D) buffer -> per-leaf (..., d_l) views in wire order."""
        return flat.split(self.sizes, dim=-1)

    def flatten(self, tree, lead: int = 0) -> Tensor:
        """Tree -> flat buffer (leading dims kept) in wire order, f32."""
        pl = leaves_with_path(tree)
        assert tuple(p for p, _ in pl) == self.paths, "tree does not match"
        cols = []
        for _, x in pl:
            t = torch.as_tensor(x)
            cols.append(t.reshape(*t.shape[:lead], -1).to(torch.float32))
        return torch.cat(cols, dim=lead)

    def views(self, flat: Tensor) -> dict:
        """Flat (..., D) buffer -> tree of its leaves, each (..., *its
        shape) with the leading dims kept: a view for a leaf of the
        buffer's dtype, a (differentiable) cast to the leaf's dtype
        otherwise."""
        out: dict = {}
        off = 0
        lead = flat.shape[:-1]
        for path, shape, n, dt in zip(self.paths, self.shapes, self.sizes,
                                      self.dtypes):
            leaf = flat[..., off:off + n].view(*lead, *shape)
            _set(out, path, leaf if dt == flat.dtype else leaf.to(dt))
            off += n
        return out

    @property
    def narrow(self) -> tuple:
        """(offset, size, dtype) of every floating leaf narrower than
        float32."""
        out, off = [], 0
        for n, dt in zip(self.sizes, self.dtypes):
            if dt.is_floating_point and dt.itemsize < 4:
                out.append((off, n, dt))
            off += n
        return tuple(out)

    def round_(self, flat: Tensor) -> Tensor:
        """Round the (..., D) float32 buffer's columns of every narrower
        leaf through that leaf's dtype, in place (the JAX trainer's cast to
        the leaf dtype); returns `flat`.  A no-op on an all-float32
        layout."""
        for off, n, dt in self.narrow:
            seg = flat[..., off:off + n]
            seg.copy_(seg.to(dt))
        return flat
