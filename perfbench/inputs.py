"""What a run feeds both the program and the reference is made from
``--seed``; this module holds the draws that every model family shares.

A family lists its weights as leaf specs and :func:`tree_from_specs` draws
them on the device in one ``torch.randn`` call, split into leaves in the
order listed. Each request's draws take a seed of their own from
:func:`request_seed`, so a request's inputs do not depend on which others
were made before it.
"""
from __future__ import annotations

import numpy as np
import torch

#: Standard deviation of the leaves that are not fan-in scaled.
SMALL_STD = 0.02


def tree_from_specs(specs: list[tuple[tuple, tuple, str]], seed: int, device) -> dict:
    """The float32 tree of ``specs`` ((path, shape, init) a leaf) from
    ``seed``, on ``device``. ``init`` "fan_in" scales a leaf by its
    second-to-last dimension's -1/2 power (N(0, 1/fan_in) for an (in, out)
    weight); "small" by :data:`SMALL_STD`."""
    sizes = [int(np.prod(shape)) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    tree: dict = {}
    for (path, shape, init), leaf in zip(specs, flat.split(sizes)):
        leaf = leaf.view(shape)
        leaf.mul_(SMALL_STD if init == "small" else shape[-2] ** -0.5)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def request_seed(seed: int, index: int, stream: int = 0) -> int:
    """A 63-bit seed of request ``index`` of a run seeded ``seed``."""
    a, b = np.random.SeedSequence([seed, index, stream]).generate_state(2)
    return (int(a) << 31 | int(b) >> 1) % 2**63
