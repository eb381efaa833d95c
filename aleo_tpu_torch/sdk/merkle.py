"""Poseidon Merkle tree over record commitments (state paths).

The role of snarkVM's ledger state tree behind `Trace::prepare(Query)`
(SURVEY.md §3.1: inclusion-proof preparation fetches state paths from a
node; the REST surface is `get_state_root`/state paths). Append-only tree,
Poseidon-2 node hash with domain separation, fixed depth padded with a
distinguished empty leaf.
"""

from __future__ import annotations

from typing import List, Tuple

from .. import params
from ..reference import poseidon

R = params.R
DEPTH = 20                      # 1M commitments per tree (devnet scale)
EMPTY_LEAF = 0


def _node(left: int, right: int) -> int:
    return poseidon.hash_psd(2, [left, right], domain="aleo-tpu/merkle-node")


class MerkleTree:
    """Append-only Poseidon Merkle tree with cached levels."""

    def __init__(self, depth: int = DEPTH):
        self.depth = depth
        self.leaves: List[int] = []
        self._empty = [EMPTY_LEAF]
        for _ in range(depth):
            self._empty.append(_node(self._empty[-1], self._empty[-1]))
        # levels[0] = leaves, levels[d] = nodes at height d
        self._levels: List[List[int]] = [[] for _ in range(depth + 1)]

    def append(self, leaf: int) -> int:
        """Add a leaf; returns its index."""
        idx = len(self.leaves)
        assert idx < (1 << self.depth), "tree full"
        self.leaves.append(leaf % R)
        self._levels[0].append(leaf % R)
        # update the path of cached nodes
        pos = idx
        for d in range(self.depth):
            level = self._levels[d]
            parent_pos = pos // 2
            lo = parent_pos * 2
            left = level[lo] if lo < len(level) else self._empty[d]
            right = level[lo + 1] if lo + 1 < len(level) else self._empty[d]
            parent = _node(left, right)
            plevel = self._levels[d + 1]
            if parent_pos < len(plevel):
                plevel[parent_pos] = parent
            else:
                plevel.append(parent)
            pos = parent_pos
        return idx

    def root(self) -> int:
        if not self.leaves:
            return self._empty[self.depth]
        return self._levels[self.depth][0]

    def prove(self, index: int) -> List[Tuple[int, bool]]:
        """Path [(sibling, sibling_is_right)] from leaf to root."""
        assert 0 <= index < len(self.leaves)
        path = []
        pos = index
        for d in range(self.depth):
            level = self._levels[d]
            if pos % 2 == 0:
                sib = level[pos + 1] if pos + 1 < len(level) else self._empty[d]
                path.append((sib, True))
            else:
                path.append((level[pos - 1], False))
            pos //= 2
        return path


def verify_path(root: int, leaf: int, path: List[Tuple[int, bool]]) -> bool:
    acc = leaf % R
    for sib, sib_is_right in path:
        acc = _node(acc, sib) if sib_is_right else _node(sib, acc)
    return acc == root
