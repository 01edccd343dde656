"""accumulate_share.train: the share, in %, of a traced training step's
host time spent on its fp32 gradient accumulators (`train.accumulate`
spans of `train.step`: their creation, each microbatch's add, the final
division), over the traced steps."""
from bench.spans import step_share


def read(run):
    return step_share(run, "train.accumulate")
