"""vae_ms.qwen: the CUDA-event spans around ``QwenImagePipeline._prepare_image``
(the Wan encode of the canvas, the packing of it and of the mask) and
``QwenImagePipeline._decode`` (the Wan decode), summed per image, in ms."""


def read(data):
    enc, dec = data["spans"].get("vae_encode"), data["spans"].get("vae_decode")
    if not enc or not dec or len(enc) != len(dec):
        return None
    return (sum(enc) + sum(dec)) / len(enc)
