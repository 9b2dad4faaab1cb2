"""Parameter trees as one flat buffer in the JAX package's leaf order.

A parameter tree is a nested dict of tensors.  Its leaves are taken in
sorted-key order at every level — the order of ``jax.tree.leaves`` on the
same dict — so the port's flat wire buffer matches the JAX trainer's
``_flatten_rows`` element for element.  ``ParamLayout`` records that order
with each leaf's shape, and turns a flat row back into a tree of views.
"""
from __future__ import annotations

import dataclasses
import math

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


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """paths/shapes of the leaves in wire order; offsets into the flat row."""

    paths: tuple
    shapes: tuple

    @classmethod
    def of(cls, tree, lead: int = 0) -> "ParamLayout":
        """Layout of a tree whose leaves carry `lead` leading batch dims
        (e.g. 1 for worker-stacked (W, ...) leaves)."""
        pl = leaves_with_path(tree)
        return cls(tuple(p for p, _ in pl),
                   tuple(tuple(x.shape[lead:]) for _, x in pl))

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
        """Flat (..., D) buffer -> tree of views into it, each leaf
        (..., *its shape) with the leading dims kept."""
        out: dict = {}
        off = 0
        lead = flat.shape[:-1]
        for path, shape, n in zip(self.paths, self.shapes, self.sizes):
            _set(out, path, flat[..., off:off + n].view(*lead, *shape))
            off += n
        return out
