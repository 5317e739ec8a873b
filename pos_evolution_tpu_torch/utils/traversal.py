"""Shared iterative tree traversal (no recursion-depth limits).

Both fork-choice implementations walk block trees that can grow far past
Python's ~1000-frame recursion limit in long simulations; every tree walk
in the package uses this explicit-stack post-order instead.
"""

from __future__ import annotations

from typing import Iterable, Iterator


def postorder(children: dict, root) -> Iterator:
    """Yield nodes of the tree under ``root`` in post-order (children
    before parents), iteratively."""
    stack = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        kids = children.get(node, ())
        if expanded or not kids:
            yield node
        else:
            stack.append((node, True))
            stack.extend((k, False) for k in kids)
