"""vace_share.wan: the VACE branch's share of one eager DiT forward, in %:
the CUDA-event pair around ``WanVACETransformer._vace`` (the ``wan.vace``
pair: the branch's 8 blocks, proj_in and the hints) over the pair around
the whole forward, in the eager forward the driver runs after the window
on the arguments of a judged step. Nothing is read when the driver kept
no pair."""


def read(data):
    vace = data.get("vace") or {}
    if not vace.get("forward_ms"):
        return None
    return 100.0 * vace["vace_ms"] / vace["forward_ms"]
