"""graph_hit_share.qwen: the DiT's ``ForwardGraphs`` counters over the
window, replays / calls, in %: the share of the window's DiT forwards that
replayed a graph captured before (the others ran eagerly or captured one).
Nothing is read when the driver kept no counters."""


def read(data):
    graphs = data.get("graphs") or {}
    if not graphs.get("calls"):
        return None
    return 100.0 * graphs["replays"] / graphs["calls"]
