"""The rank body of the multi-rank gloo test in tests/test_torch_distributed.py.

Started by ``torch.multiprocessing`` in fresh interpreters, so it imports
only ``torch`` and the port (not JAX). Each rank runs the compressed
all-reduce on its own gradient and lays the given leaves out on the mesh,
then saves what it holds to ``out_dir/rank<r>.pt`` for the parent to check.
"""
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed import collectives, sharding


def run(rank: int, world: int, store_path: str, out_dir: str, job: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        g = job["grads"][rank]
        mean, resid = collectives.compressed_psum_grads(
            {"g": g}, collectives.zeros_residuals({"g": g}))
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(job["mesh_shape"]),
                          mesh_dim_names=job["mesh_names"])
        shard = sharding.make_shard_fn(job["rules"], mesh)
        local = {k: shard(v, axes).to_local() for k, (v, axes) in job["leaves"].items()}
        torch.save({"coord": tuple(mesh.get_coordinate()), "mean": mean["g"],
                    "resid": resid["g"], "local": local},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
