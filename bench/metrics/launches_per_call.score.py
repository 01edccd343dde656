"""launches_per_call.score: the kernels the device ran in the traced
window (an exact count from the trace) over the scoring calls in it."""


def read(run):
    tr, calls = run.get("trace"), run.get("calls")
    if not tr or not calls:
        return None
    return tr["launches"] / len(calls)
