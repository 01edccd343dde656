"""forward_share.train: the share, in %, of a traced training step's host
time spent in its microbatches' forward and loss (`train.forward` spans
of `train.step`), over the traced steps."""
from bench.spans import step_share


def read(run):
    return step_share(run, "train.forward")
