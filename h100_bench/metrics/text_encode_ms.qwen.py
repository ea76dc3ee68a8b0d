"""text_encode_ms.qwen: the CUDA-event span around
``QwenImagePipeline.encode_prompts`` (the Qwen2.5 encoder over the prompt
and over the negative prompt), per image, in ms."""


def read(data):
    ms = data["spans"].get("text_encode")
    return sum(ms) / len(ms) if ms else None
