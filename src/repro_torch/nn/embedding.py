"""Token embedding + LM head. Mirror of ``src/repro/nn/embedding.py``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed import sharding
from . import core
from .core import val


def embed_init(gen: torch.Generator, vocab: int, d_model: int, *, dtype=torch.float32) -> dict:
    return {"table": core.tag(core.normal_init(gen, (vocab, d_model), stddev=0.02, dtype=dtype),
                              ("vocab", "embed"))}


def embed(params: dict, tokens: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    # F.embedding, not ``table[tokens]``: the same rows, and on the card its
    # backward sorts the ids and sums each row's gradients in a fixed order
    # (indexing's backward adds them with atomics), so a train step repeats
    # bit for bit
    table = val(params["table"])
    if isinstance(table, DTensor):
        y = _embed_split(tokens, table)
    else:
        y = F.embedding(tokens, table)
    return y * torch.full((), scale, dtype=y.dtype, device=y.device) if scale != 1.0 else y


def _embed_split(tokens: torch.Tensor, table: DTensor) -> DTensor:
    """The vocab-parallel lookup of a DTensor table, equal to ``F.embedding``:
    the table's embed dim gathered (an FSDP split), its vocab split kept;
    each rank looks up the ids of its vocab block (the rest read as zero
    rows) and the rows are summed over the vocab's mesh dims at once (one
    rank adds each row, the others zeros: the same bits). DTensor's own
    lookup returns a masked partial sum that breaks when a later op
    reduces it on a 2-D mesh."""
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    t_pl = [p if p == Shard(0) else Replicate() for p in table.placements]
    vocab = [i for i, p in enumerate(t_pl) if p == Shard(0)]
    x_pl = [Replicate() if i in vocab or not p.is_shard() else p
            for i, p in enumerate(tokens.placements)]
    rows = table.shape[0] // math.prod(mesh.size(i) for i in vocab)
    block = 0
    for i in vocab:  # the vocab block this rank holds (mesh dims in order, the first major)
        block = block * mesh.size(i) + mesh.get_coordinate()[i]
    lo = block * rows

    def lookup(ids, tab):
        ids = ids - lo
        inside = (ids >= 0) & (ids < rows)
        return torch.where(inside[..., None], F.embedding(torch.where(inside, ids, 0), tab), 0)

    out_pl = [Partial() if i in vocab else p for i, p in enumerate(x_pl)]
    # a rank's table gradient: its vocab block, summed over the batch split
    grad_pl = [Shard(0) if i in vocab else Partial() if p.is_shard() else Replicate()
               for i, p in enumerate(x_pl)]
    y = local_map(lookup, out_placements=out_pl, in_placements=(x_pl, t_pl),
                  in_grad_placements=(x_pl, grad_pl), device_mesh=mesh,
                  redistribute_inputs=True)(tokens, table)
    return sharding.reduced(y)


def head_init(gen: torch.Generator, d_model: int, vocab: int, *, dtype=torch.float32) -> dict:
    return {"w": core.tag(core.normal_init(gen, (d_model, vocab), stddev=0.02, dtype=dtype),
                          ("embed", "vocab"))}


def logits(params: dict | None, x: torch.Tensor, *,
           tied_table: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ W`` of the head, or ``x @ table.T`` of a tied embedding (on
    DTensors as ``nn/core.py:matmul_split`` lays a product out)."""
    w = val(tied_table).to(x.dtype).T if tied_table is not None else val(params["w"]).to(x.dtype)
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return core.matmul_split(x, w)
    return x @ w
