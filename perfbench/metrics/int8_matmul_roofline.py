"""int8_matmul_roofline: the sum of each ``int8_matmul`` launch's bound in
the window over the kernel's device time there, in %.

The launches of a replayed step follow from its runner key (the layers'
modes and the bucket: the cell's family's ``int8_matmul_launches``) and
the window's replays of each key. Nothing is read unless that count equals
both the runner cache's own (its launches a capture x the replays) and the
launches the trace shows."""
import sys

from perfbench import roofline
from perfbench.harness import KERNELS


def read(run):
    if run.trace is None:
        return None
    part = KERNELS["int8_matmul"]
    kernel_s, traced = run.trace.kernel_s(run.t_open, run.t_close, part)
    bound, counted, cached = 0.0, 0, 0
    for key, (modes, bucket, launches) in run.keys.items():
        n = run.close_snap["replays"].get(key, 0) - run.open_snap["replays"].get(key, 0)
        if not n:
            continue
        shapes = run.cell.family.int8_matmul_launches(run.model, modes, bucket)
        bound += n * sum(roofline.launch_bound(*roofline.int8_matmul_work(*s)) for s in shapes)
        counted += n * len(shapes)
        cached += n * launches.get("int8_matmul", 0)
    if not counted or not kernel_s or not counted == cached == traced:
        print(f"int8_matmul_roofline: launches counted {counted}, cache {cached}, "
              f"trace {traced}; not read", file=sys.stderr)
        return None
    return 100.0 * bound / kernel_s
