"""Regex rules -> PartitionSpecs over named parameter trees: counterpart
of ``ray_tpu/parallel/partition_rules.py``.

``match_partition_rules(rules, tree)`` names every leaf by its path and
gives it the spec of the first rule whose regex ``re.search``-matches
the name.  The rules are written against flax's slash-joined paths
(``h_0/c_attn/kernel``).  The port's trees are nested mappings and
``state_dict``s, whose keys join names with dots (``h_0.c_attn.kernel``):
``_leaves`` splits dotted keys, so a ``state_dict`` and the nested flax
tree of ``models/convert.py`` give the same names, and this is the one
place that maps between the two.  Scalar (single-element) leaves get an
empty spec; a leaf no rule covers raises unless a ``default`` is given.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

from .sharding import PartitionSpec, spec_placements

# A rule set is an ordered sequence of (regex, PartitionSpec) pairs;
# first match wins, so put the most specific patterns first.
Rules = Sequence[Tuple[str, Any]]


def _leaves(tree: Any, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path parts, leaf) in order: mapping keys (dotted keys split into
    their parts) and sequence indices."""
    if isinstance(tree, Mapping):
        for key, val in tree.items():
            yield from _leaves(val, prefix + tuple(str(key).split(".")))
    elif isinstance(tree, (list, tuple)) and not isinstance(
            tree, PartitionSpec):
        for i, val in enumerate(tree):
            yield from _leaves(val, prefix + (str(i),))
    else:
        yield prefix, tree


def path_name(parts: Tuple, sep: str = "/") -> str:
    return sep.join(parts)


def tree_paths(tree: Any, sep: str = "/") -> List[str]:
    """Slash-joined leaf names of a tree, in order."""
    return [path_name(p, sep) for p, _leaf in _leaves(tree)]


def named_tree_map(fn: Callable[[str, Any], Any], tree: Any,
                   sep: str = "/") -> Any:
    """The tree with each leaf replaced by ``fn(name, leaf)``; mappings
    keep their keys (dotted or nested) and sequences their order."""

    def walk(node, prefix):
        if isinstance(node, Mapping):
            return {k: walk(v, prefix + tuple(str(k).split(".")))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not isinstance(
                node, PartitionSpec):
            return type(node)(walk(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        return fn(path_name(prefix, sep), node)

    return walk(tree, ())


def _is_scalar(leaf: Any) -> bool:
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return True
    n = 1
    for d in shape:
        n *= d
    return len(shape) == 0 or n == 1


def match_partition_rules(rules: Rules, params: Any, *,
                          default: Any = None, sep: str = "/") -> Any:
    """A tree of PartitionSpecs, one per leaf of ``params``: empty for a
    scalar leaf, else the spec of the first rule whose regex matches the
    leaf's name.  An unmatched leaf raises ``ValueError`` naming it
    unless ``default`` is given."""

    def get_spec(name: str, leaf: Any):
        if _is_scalar(leaf):
            return PartitionSpec()
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                return spec
        if default is not None:
            return default
        raise ValueError(f"partition rule not found for param: {name}")

    return named_tree_map(get_spec, params, sep=sep)


# --------------------------------------------------- spec (de)serialize
def spec_to_json(spec: Any) -> List:
    """PartitionSpec -> JSON-able list: each entry None | str | [str]."""
    out: List = []
    for entry in tuple(spec):
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            out.append([str(a) for a in entry])
        else:
            out.append(str(entry))
    return out


def spec_from_json(data: Optional[Sequence]) -> PartitionSpec:
    if not data:
        return PartitionSpec()
    entries = []
    for entry in data:
        if entry is None:
            entries.append(None)
        elif isinstance(entry, (tuple, list)):
            entries.append(tuple(entry))
        else:
            entries.append(str(entry))
    return PartitionSpec(*entries)


def prune_spec(spec: Any, axis_sizes: Dict[str, int]) -> PartitionSpec:
    """Drop mesh axes a mesh lacks (or has at size 1) from a spec, and
    trailing None entries."""
    entries = []
    for entry in tuple(spec):
        if entry is None:
            entries.append(None)
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        kept = tuple(a for a in axes if axis_sizes.get(a, 1) > 1)
        if not kept:
            entries.append(None)
        elif len(kept) == 1:
            entries.append(kept[0])
        else:
            entries.append(kept)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def tree_shardings(mesh, spec_tree: Any) -> Any:
    """A ``NamedSharding`` per leaf of a spec tree, each spec pruned to
    the mesh's axes first (so a spec for a bigger mesh stays valid)."""
    from .mesh import mesh_axis_sizes

    sizes = mesh_axis_sizes(mesh)
    return named_tree_map(
        lambda _name, spec: spec_placements(mesh, prune_spec(spec, sizes)),
        spec_tree)


def shard_tree(tree: Any, mesh, rules: Rules, *, default: Any = None):
    """Every tensor leaf as a DTensor under the sharding its matching
    rule dictates, from the full value every rank holds (other leaves,
    such as a step count, stay as they are)."""
    import torch

    from .mesh import mesh_axis_sizes
    from .sharding import distribute

    sizes = mesh_axis_sizes(mesh)
    specs = {path_name(p): s for p, s in
             _leaves(match_partition_rules(rules, tree, default=default))}

    def place(name, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute(leaf, spec_placements(
            mesh, prune_spec(specs[name], sizes)))

    return named_tree_map(place, tree)
