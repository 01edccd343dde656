"""launches_per_step.train: the kernels the device ran in the traced
window (an exact count from the trace) over the training steps in it."""


def read(run):
    tr, n = run.get("trace"), run.get("steps")
    if not tr or not n:
        return None
    return tr["launches"] / n
