"""text_encode_ms.serve: the CUDA-event span around
``FillPipeline.encode_prompts`` (CLIP-L and T5-XXL), per image, in ms."""


def read(data):
    ms = data["spans"].get("text_encode")
    return sum(ms) / len(ms) if ms else None
