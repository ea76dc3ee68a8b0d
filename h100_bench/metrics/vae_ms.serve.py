"""vae_ms.serve: the CUDA-event spans around ``FillPipeline._prepare_cond``
(the VAE encode of the masked canvas and the packing) and
``FillPipeline._decode`` (the VAE decode), summed per image, in ms."""


def read(data):
    enc, dec = data["spans"].get("vae_encode"), data["spans"].get("vae_decode")
    if not enc or not dec or len(enc) != len(dec):
        return None
    return (sum(enc) + sum(dec)) / len(enc)
