"""mfu: the model's dense operations over the window (2 x the MACs of a
forward, from the cell's family, x sampling steps x images completed) over
its wall, as a share of the card's int8 dense peak, in %."""
from perfbench import roofline


def read(run):
    macs = run.cell.family.model_macs(run.model)
    ops = 2.0 * macs * run.cell.config["plan"]["steps"] * run.images
    if not ops:
        return None
    return 100.0 * ops / run.window_s / roofline.PEAK_INT8_OPS
