"""Turn the reference's parameter tree into the port's.

The input is the JAX package's param tree as nested dicts of numpy arrays
(the caller unwraps ``Param`` leaves and converts arrays with
``numpy.asarray``; this module imports neither JAX nor the JAX package),
with per-block params stacked on a leading layer axis as
``src/repro/nn/dit.py`` ``init`` and ``src/repro/models/lm.py``
``LM.init`` make them. The port keeps that layout, so the conversion is
leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernels.common import resolve_device
from .tree import map_tree


def params_from_numpy(tree: dict, *, device=None) -> dict:
    """Nested dicts of numpy arrays -> the same tree of tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return map_tree(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)
