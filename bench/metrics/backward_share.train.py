"""backward_share.train: the share, in %, of a traced training step's
host time spent in its microbatches' backward, the checkpoint's
recompute included (`train.backward` spans of `train.step`: the calling
thread waits while autograd's device thread dispatches), over the traced
steps."""
from bench.spans import step_share


def read(run):
    return step_share(run, "train.backward")
