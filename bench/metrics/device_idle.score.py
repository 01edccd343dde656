"""device_idle.score: the share of the traced scoring window in which no
kernel, copy or set ran on the device, in %."""


def read(run):
    tr = run.get("trace")
    if not tr or not run.get("calls"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
