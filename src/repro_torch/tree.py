"""Walking nested state: dicts, lists, tuples and dataclasses of tensors."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf; other leaves are kept as they
    are.  Dataclass instances are rebuilt with ``dataclasses.replace``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/field": leaf} for any nest of dicts, lists and dataclasses —
    the same paths for the port's state and the reference's (both use the
    same keys and field names)."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(flatten(getattr(tree, f.name), f"{prefix}{f.name}/"))
        return out
    return {prefix.rstrip("/"): tree}
