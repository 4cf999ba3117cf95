"""Small shared utilities: parameter path strings and byte formatting.

The port's parameters are nested dicts and lists of tensors.  A leaf's
path is its keys and list indices joined by dots (``layers.3.attn.wq``),
the port's counterpart of ``repro.utils.path_str`` over a JAX pytree.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def named_leaves(tree, prefix: str = "") -> Iterator[tuple]:
    """``(path, leaf)`` for every leaf of a nested dict/list, in order."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from named_leaves(val, f"{prefix}{key}.")
    elif isinstance(tree, list):
        for i, val in enumerate(tree):
            yield from named_leaves(val, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """The same nested dict/list with every leaf replaced by
    ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def unflatten_like(like, leaves) -> Any:
    """The nested dict/list shape of ``like`` with its leaves taken in
    order from the iterator ``leaves`` (the inverse of :func:`named_leaves`)."""
    if isinstance(like, dict):
        return {k: unflatten_like(v, leaves) for k, v in like.items()}
    if isinstance(like, list):
        return [unflatten_like(v, leaves) for v in like]
    return next(leaves)


def tensor_nbytes(t) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    return sum(tensor_nbytes(t) for _, t in named_leaves(tree))


def fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} PiB"
