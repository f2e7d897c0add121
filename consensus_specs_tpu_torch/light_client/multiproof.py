"""Generalized-index Merkle multiproofs over SSZ hash trees.

Contract: consensus-specs specs/light_client/merkle_proofs.md —
generalized index = 2^depth + position (:26-45), SSZ-object-to-index paths
(:47-104), minimal multiproofs (:106-165), SSZMerklePartial (:167-187).

Own construction: the prover materializes the object's full hash tree as a
{generalized_index: node} map by recursive composition (a child subtree
rooted at parent index c maps node x to c shifted onto x's path); the
verifier folds sibling pairs upward from the supplied leaves + helper
nodes until the root reproduces. Helper-index selection keeps every
sibling along each leaf's ascent that the proof cannot derive itself.

Port of consensus_specs_tpu/light_client/multiproof.py (host code).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Union

from ..utils.hash import sha256, zerohashes
from ..utils.ssz.impl import (
    chunkify, hash_tree_root, is_basic_type, is_bottom_layer_kind, pack,
    serialize_basic)
from ..utils.ssz.typing import (
    is_bytesn_type, is_container_type, is_list_kind, is_uint_type,
    is_vector_type, read_elem_type, uint_byte_size)

LENGTH_FLAG = 2 ** 64 - 1   # path element selecting len(list)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < max(1, n):
        p *= 2
    return p


def _compose(parent: int, child: int) -> int:
    """Graft a child-subtree generalized index onto its parent node's."""
    span = 1 << (child.bit_length() - 1)
    return parent * span + (child - span)


def merkle_tree_nodes(leaves: Sequence[bytes]) -> Dict[int, bytes]:
    """{generalized_index: node} for a pow2-padded chunk list (1 = root)."""
    n = _pow2_at_least(len(leaves))
    depth = (n - 1).bit_length()
    nodes: Dict[int, bytes] = {}
    level = [bytes(x) for x in leaves] + \
        [zerohashes[0]] * (n - len(leaves))
    base = n
    for d in range(depth, -1, -1):
        for i, node in enumerate(level):
            nodes[base + i] = node
        if base == 1:
            break
        level = [sha256(level[i] + level[i + 1]) for i in range(0, len(level), 2)]
        base //= 2
    return nodes


# ---------------------------------------------------------------------------
# SSZ object -> full generalized-index tree
# ---------------------------------------------------------------------------

def object_tree(value: Any, typ: Any) -> Dict[int, bytes]:
    """The complete hash tree of an SSZ value as {generalized_index: node}.

    List kinds get the spec shape: node 2 = data subtree root, node 3 =
    the little-endian length chunk (so `["y", LENGTH_FLAG]` paths resolve).
    """
    nodes: Dict[int, bytes] = {}

    def fill(value, typ, root: int) -> bytes:
        if is_list_kind(typ):
            data_root = fill_composite_data(value, typ, _compose(root, 2))
            length_chunk = len(value).to_bytes(32, "little")
            nodes[_compose(root, 3)] = length_chunk
            out = sha256(data_root + length_chunk)
            nodes[root] = out
            return out
        out = fill_composite_data(value, typ, root)
        return out

    def fill_composite_data(value, typ, root: int) -> bytes:
        if is_bottom_layer_kind(typ):
            data = serialize_basic(value, typ) if is_basic_type(typ) \
                else pack(value, read_elem_type(typ))
            local = merkle_tree_nodes(chunkify(data))
        elif is_container_type(typ):
            child_roots = [
                fill(v, t, _compose_child(root, i, len(typ.get_fields())))
                for i, (v, t) in enumerate(value.get_typed_values())
            ]
            local = merkle_tree_nodes(child_roots)
        else:   # vector/list of composite elements
            elem = typ.elem_type
            count = len(value)
            child_roots = [
                fill(v, elem, _compose_child(root, i, count))
                for i, v in enumerate(value)
            ]
            local = merkle_tree_nodes(child_roots or [zerohashes[0]])
        for local_idx, node in local.items():
            nodes.setdefault(_compose(root, local_idx), node)
        return local[1]

    def _compose_child(root: int, i: int, count: int) -> int:
        width = _pow2_at_least(count)
        return _compose(root, width + i)

    fill(value, typ, 1)
    return nodes


@dataclass
class SSZMerkleTree:
    """Prover-side wrapper: full node map + proof construction."""
    value: Any
    typ: Any
    nodes: Dict[int, bytes] = field(default_factory=dict)

    def __post_init__(self):
        if not self.nodes:
            self.nodes = object_tree(self.value, self.typ)
        assert self.nodes[1] == hash_tree_root(self.value, self.typ)

    @property
    def root(self) -> bytes:
        return self.nodes[1]

    def prove(self, indices: Sequence[int]) -> "MerklePartial":
        helpers = get_helper_indices(indices)
        return MerklePartial(
            root=self.root,
            indices=list(indices),
            values=[self.nodes[i] for i in indices],
            proof=[self.nodes[i] for i in helpers],
        )


# ---------------------------------------------------------------------------
# Paths -> generalized indices
# ---------------------------------------------------------------------------

def generalized_index_for_path(value: Any, typ: Any,
                               path: Sequence[Union[str, int]]) -> int:
    """Generalized index of the node a human-readable path selects:
    field names for containers, integers for vector/list elements,
    LENGTH_FLAG for a list's length mix-in.

    Thin wrapper over the value-free core: walks the value once to read
    the list lengths the path crosses, then delegates — prover and
    verifier therefore share ONE index computation by construction."""
    lengths: Dict[tuple, int] = {}
    v, t, prefix = value, typ, ()
    for head in path:
        if is_container_type(t):
            sub = t.get_field_names().index(head)
            v, t = getattr(v, head), t.get_field_types()[sub]
        elif is_list_kind(t):
            if head == LENGTH_FLAG or head == "__len__":
                break
            lengths[prefix] = len(v)
            if t is bytes or is_basic_type(t.elem_type):
                break
            v, t = v[head], t.elem_type
        elif is_vector_type(t):
            if is_basic_type(t.elem_type):
                break
            v, t = v[head], t.elem_type
        else:   # BytesN leaf
            break
        prefix = prefix + (head,)
    return generalized_index_for_typed_path(typ, path, lengths)


def generalized_index_for_typed_path(typ: Any, path: Sequence[Union[str, int]],
                                     list_lengths: Dict[tuple, int],
                                     _prefix: tuple = ()) -> int:
    """Value-free index computation — the core both sides share. The
    caller supplies `list_lengths[path_prefix]` for every List the path
    crosses (a VERIFIER reads them from proven length leaves; the prover
    wrapper above reads them from the object). Vector/container widths are
    static from the type."""
    if not path:
        return 1
    head, rest = path[0], path[1:]

    if is_list_kind(typ):
        if head == LENGTH_FLAG or head == "__len__":
            assert not rest
            return 3
        length = list_lengths[_prefix]
        if typ is bytes:
            assert not rest
            return _compose(2, _pow2_at_least((length + 31) // 32) + head // 32)
        elem = typ.elem_type
        if is_basic_type(elem):
            per_chunk = 32 // uint_byte_size(elem) if is_uint_type(elem) else 32
            count = (length + per_chunk - 1) // per_chunk
            assert not rest
            return _compose(2, _pow2_at_least(count) + head // per_chunk)
        width = _pow2_at_least(length)
        return _compose(2, _compose(
            width + head,
            generalized_index_for_typed_path(elem, rest, list_lengths,
                                             _prefix + (head,))))

    if is_container_type(typ):
        names = typ.get_field_names()
        position = names.index(head)
        width = _pow2_at_least(len(names))
        sub_typ = typ.get_field_types()[position]
        return _compose(width + position,
                        generalized_index_for_typed_path(
                            sub_typ, rest, list_lengths, _prefix + (head,)))

    if is_vector_type(typ):
        elem = typ.elem_type
        if is_basic_type(elem):
            per_chunk = 32 // uint_byte_size(elem) if is_uint_type(elem) else 32
            count = (typ.length + per_chunk - 1) // per_chunk
            assert not rest
            return _pow2_at_least(count) + head // per_chunk
        width = _pow2_at_least(typ.length)
        return _compose(width + head,
                        generalized_index_for_typed_path(
                            elem, rest, list_lengths, _prefix + (head,)))

    if is_bytesn_type(typ):
        assert not rest
        return _pow2_at_least((typ.length + 31) // 32) + head // 32

    raise TypeError(f"cannot path into {typ}")


# ---------------------------------------------------------------------------
# Multiproofs
# ---------------------------------------------------------------------------

def get_helper_indices(indices: Sequence[int]) -> List[int]:
    """Auxiliary node indices a multiproof for `indices` must supply: the
    union of every leaf's branch (siblings along its ascent) minus the
    union of every leaf's path (itself + ancestors) — anything on a path
    is computed during verification, so only off-path siblings ship."""
    branches = set()
    paths = set()
    for index in indices:
        x = index
        while x > 1:
            branches.add(x ^ 1)
            paths.add(x)
            x //= 2
    return sorted(branches - paths, reverse=True)


def verify_multiproof(root: bytes, indices: Sequence[int],
                      leaves: Sequence[bytes], proof: Sequence[bytes]) -> bool:
    """Check that `leaves` sit at `indices` under `root`, given the helper
    nodes `proof` (in get_helper_indices order)."""
    if not indices:
        return True
    helper_indices = get_helper_indices(indices)
    if len(leaves) != len(indices) or len(proof) != len(helper_indices):
        return False
    known: Dict[int, bytes] = dict(zip(indices, leaves))
    known.update(zip(helper_indices, proof))
    frontier = sorted(known, reverse=True)
    pos = 0
    while pos < len(frontier):
        idx = frontier[pos]
        pos += 1
        if idx == 1:
            continue
        sibling = idx ^ 1
        parent = idx // 2
        if parent in known or sibling not in known:
            continue
        left, right = (idx, sibling) if idx % 2 == 0 else (sibling, idx)
        known[parent] = sha256(known[left] + known[right])
        frontier.append(parent)
        frontier.sort(reverse=True)   # small proofs; clarity over speed
    return known.get(1) == root


@dataclass
class MerklePartial:
    """SSZMerklePartial (merkle_proofs.md:167-187): enough of an object's
    hash tree to authenticate chosen nodes against the root."""
    root: bytes
    indices: List[int]
    values: List[bytes]
    proof: List[bytes]

    def verify(self) -> bool:
        return verify_multiproof(self.root, self.indices, self.values, self.proof)

    def value_at(self, index: int) -> bytes:
        return self.values[self.indices.index(index)]
