"""Nested dict/list/tuple parameter trees, the port's stand-in for pytrees.

Leaf names join the keys and list positions with ``/``, as the JAX
package's checkpoint names do (``emb2/dense``, ``deep/net_1/layers/0/w``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) pairs in insertion order; ``None`` subtrees are skipped."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf, keeping dicts, lists and tuples."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``tree_map`` whose ``fn`` also takes the leaf's name."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def rebuild(template: Any, flat: Dict[str, Any], prefix: str = "") -> Any:
    """``template``'s structure (empty containers included) with each leaf
    replaced by ``flat[its name]``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: rebuild(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(rebuild(v, flat, f"{prefix}{i}/") for i, v in enumerate(template))
    return flat[prefix[:-1]]


def unflatten(flat: Dict[str, Any]) -> Dict:
    """``{"a/0/w": x}`` → ``{"a": [{"w": x}]}``: a dict whose keys are all
    the integers 0..n-1 becomes a list, as in the JAX layer lists."""
    root: Dict = {}
    for name, value in flat.items():
        node = root
        keys = name.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return _listify(root)


def _listify(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node) \
            and sorted(int(k) for k in node) == list(range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node
