"""optimizer_share.train: the share, in %, of a traced training step's
host time spent in the schedule and the optimizer's update
(`train.optimizer`, a child of `train.step`), over the traced steps. The
device follows this phase's dispatch, so it is AdamW's launch cost, not
its HBM time."""
from bench.spans import step_share


def read(run):
    return step_share(run, "train.optimizer")
