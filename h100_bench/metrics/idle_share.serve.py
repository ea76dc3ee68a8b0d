"""idle_share.serve: 1 - the device's busy time (the union of its kernels,
copies and sets) over the wall time of the profiled request, in %."""


def read(data):
    trace = data.get("trace") or {}
    if not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
