"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with sm_90a (Hopper) and nvcc; they carry the
``cuda`` marker and skip where there is no CUDA device. On a machine with
the card (tests/conftest.py imports JAX, which the port's machines need not
have, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import numpy as np
import pytest
import torch

from textflux_torch.ops import flash_attention as FA, packing
from textflux_torch.ops.attention import FlashAttention
from textflux_torch.ops.rope import rope_tables_half

pytestmark = pytest.mark.cuda

BF16_TOL = 2e-2   # unit-scale inputs; q/k/p/out rounded to bf16


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(cuda, *, b, t_txt, lat_hw, h, d, axes, per_row):
    g = torch.Generator(device=cuda).manual_seed(0)
    ids = np.concatenate([packing.text_ids(t_txt), packing.latent_image_ids(*lat_hw)], 0)
    s = len(ids)
    cos, sin = (torch.as_tensor(x, device=cuda) for x in rope_tables_half(ids, axes))
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))

    def scale():
        return 1 + 0.1 * torch.randn(d, generator=g, device=cuda)

    def scales():
        if per_row:   # double-block tables: txt rows and img rows differ
            return torch.cat([scale().expand(t_txt, d), scale().expand(s - t_txt, d)])
        return scale()

    return q, k, v, cos, sin, scales(), scales()


@pytest.mark.parametrize("case", [
    dict(b=1, t_txt=512, lat_hw=(56, 64), h=24, d=128, axes=(16, 56, 56), per_row=True,
         kv_len=None),
    dict(b=1, t_txt=512, lat_hw=(56, 64), h=24, d=128, axes=(16, 56, 56), per_row=True,
         kv_len=1300),
    dict(b=1, t_txt=104, lat_hw=(56, 64), h=24, d=128, axes=(16, 56, 56), per_row=False,
         kv_len=None),
    dict(b=2, t_txt=64, lat_hw=(32, 32), h=8, d=64, axes=(16, 24, 24), per_row=False,
         kv_len=None),
    # the multi-line serving shape: a 2048x1024 canvas, 512 + 8192 tokens
    dict(b=1, t_txt=512, lat_hw=(128, 256), h=24, d=128, axes=(16, 56, 56), per_row=True,
         kv_len=None),
], ids=["serving", "serving_kv_len", "ragged_s1000", "d64", "multiline_s8704"])
def test_kernel_matches_plain_version(case, cuda):
    kv_len = case.pop("kv_len")
    q, k, v, cos, sin, qs, ks = _case(cuda, **case)
    before = FA.flash_attention_qk_norm_rope.launches
    out = FA.flash_attention_qk_norm_rope(q, k, v, cos, sin, qs, ks, kv_len=kv_len)
    torch.cuda.synchronize()
    assert FA.flash_attention_qk_norm_rope.launches == before + 1
    ref = FA.flash_attention_qk_norm_rope_reference(q, k, v, cos, sin, qs, ks, kv_len=kv_len)
    rows = slice(None) if kv_len is None else slice(0, kv_len)
    err = (out[:, rows].float() - ref[:, rows].float()).abs().max().item()
    assert err <= BF16_TOL


@pytest.mark.parametrize("tp", [2, 4])
def test_kernel_at_tensor_parallel_heads(tp, cuda):
    """A tensor-parallel rank's attention: H / tp heads (12, 6) at the
    serving shape, the double blocks' per-row tables, and the single
    blocks' q/k/v as strided views of the rank's local linear1 rows
    [q_r | k_r | v_r | mlp_r] (row width 7 * 3072 / tp)."""
    h = 24 // tp
    q, k, v, cos, sin, qs, ks = _case(cuda, b=1, t_txt=512, lat_hw=(56, 64), h=h, d=128,
                                      axes=(16, 56, 56), per_row=True)
    out = FA.flash_attention_qk_norm_rope(q, k, v, cos, sin, qs, ks)
    ref = FA.flash_attention_qk_norm_rope_reference(q, k, v, cos, sin, qs, ks)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    g = torch.Generator(device=cuda).manual_seed(1)
    local = torch.randn(1, q.shape[1], 7 * h * 128, generator=g, device=cuda).to(torch.bfloat16)
    qv, kv, vv = (local[..., i * h * 128:(i + 1) * h * 128].unflatten(-1, (h, 128))
                  for i in range(3))
    before = FA.flash_attention_qk_norm_rope.launches
    out = FA.flash_attention_qk_norm_rope(qv, kv, vv, cos, sin, qs[0], ks[0])
    assert FA.flash_attention_qk_norm_rope.launches == before + 1
    ref = FA.flash_attention_qk_norm_rope_reference(qv, kv, vv, cos, sin, qs[0], ks[0])
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


def test_kernel_takes_strided_rows(cuda):
    """Single blocks hand over q/k/v as strided views of the fused
    projection; the kernel reads them in place."""
    q, k, v, cos, sin, qs, ks = _case(cuda, b=1, t_txt=16, lat_hw=(16, 16), h=4, d=128,
                                      axes=(16, 56, 56), per_row=False)
    fused = torch.cat([q, k, v, q], dim=-2)           # (B, S, 4H, D): rows carry an extra block
    qv, kv, vv = fused[:, :, :4], fused[:, :, 4:8], fused[:, :, 8:12]
    out = FA.flash_attention_qk_norm_rope(qv, kv, vv, cos, sin, qs, ks)
    ref = FA.flash_attention_qk_norm_rope_reference(q, k, v, cos, sin, qs, ks)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL


def test_prep_pass_matches_plain_version(cuda):
    """The fused kernel's first launch alone: q' and k' against the plain
    fp32 norm+rope rounded to bf16 (one bf16 rounding apart at most)."""
    q, k, v, cos, sin, qs, ks = _case(cuda, b=1, t_txt=512, lat_hw=(56, 64), h=24, d=128,
                                      axes=(16, 56, 56), per_row=True)
    tables = FA.fold_tables(cos, sin, qs, ks)
    qn, kn = FA.norm_rope_prep(q, k, *tables)
    ref_q, ref_k = FA._prep_reference(q, k, *tables, 1e-6, torch.bfloat16)
    assert (qn.float() - ref_q.transpose(1, 2).float()).abs().max().item() <= BF16_TOL
    assert (kn.float() - ref_k.transpose(1, 2).float()).abs().max().item() <= BF16_TOL


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, cos, sin, qs, ks = _case(cuda, b=1, t_txt=8, lat_hw=(8, 8), h=2, d=64,
                                      axes=(16, 24, 24), per_row=False)
    with pytest.raises(TypeError, match="bfloat16"):
        FA.flash_attention_qk_norm_rope(q.float(), k.float(), v.float(), cos, sin, qs, ks)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention_qk_norm_rope(q[..., :32], k[..., :32], v[..., :32], cos[:, :32],
                                        sin[:, :32], qs[:32], ks[:32])
    with pytest.raises(ValueError, match="stride"):
        FA.flash_attention_qk_norm_rope(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                                        cos, sin, qs, ks)


# ---------------------------------------------------------------------------
# the training kernels: flash forward, LSE, dQ, dK/dV
# ---------------------------------------------------------------------------

LSE_TOL = 1e-3    # fp32 output, only the summation order differs


def _rel(out, ref):
    ref = ref.float()
    return float((out.float() - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def _flash_inputs(cuda, b, s, h, d, strided):
    g = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16)

    if strided:   # views of a fused [q | k | v | mlp] row, as linear1 gives them
        fused = randn(b, s, 7 * h * d)
        q, k, v = (fused[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d)) for i in range(3))
    else:
        q, k, v = (randn(b, s, h, d) for _ in range(3))
    return q, k, v, randn(b, s, h, d)


@pytest.mark.parametrize("b,s,h,d,kv_len,strided", [
    (1, 1408, 24, 128, None, False),
    (1, 1408, 24, 128, 1300, False),
    (1, 1000, 8, 128, None, False),
    (1, 1408, 8, 128, None, True),
    (2, 320, 8, 64, 250, False),
    (2, 1000, 24, 128, 900, False),
    (1, 8704, 24, 128, None, False),
], ids=["s1408", "kv_len1300", "ragged_s1000", "strided", "d64_kv_len", "batch2_ragged_kv900",
        "multiline_s8704"])
def test_flash_kernels_match_plain_versions(b, s, h, d, kv_len, strided, cuda):
    q, k, v, do = _flash_inputs(cuda, b, s, h, d, strided)
    n = s if kv_len is None else kv_len
    names = ("flash_attention", "flash_attention_lse", "flash_attention_dq",
             "flash_attention_dkv")
    before = [getattr(FA, x).launches for x in names]
    o, lse_fwd = FA.flash_attention_fwd(q, k, v, kv_len=kv_len)
    lse = FA.flash_attention_lse(q, k, kv_len=kv_len)
    dvec = FA.attention_dvec(o, do)
    dq = FA.flash_attention_dq(q, k, v, do, lse, dvec, kv_len=kv_len)
    dk, dv = FA.flash_attention_dkv(q, k, v, do, lse, dvec, kv_len=kv_len)
    torch.cuda.synchronize()
    assert [getattr(FA, x).launches for x in names] == [x + 1 for x in before]
    assert _rel(o, FA.flash_attention_reference(q, k, v, kv_len=kv_len)) <= BF16_TOL
    ref_lse = FA.flash_attention_lse_reference(q, k, kv_len=kv_len)
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL
    assert float((lse_fwd - ref_lse).abs().max()) <= LSE_TOL   # the forward's L
    assert _rel(dq, FA.flash_attention_dq_reference(q, k, v, do, lse, dvec, kv_len=kv_len)) \
        <= BF16_TOL
    ref_dk, ref_dv = FA.flash_attention_dkv_reference(q, k, v, do, lse, dvec, kv_len=kv_len)
    assert _rel(dk, ref_dk) <= BF16_TOL and _rel(dv, ref_dv) <= BF16_TOL
    assert not dk[:, n:].any() and not dv[:, n:].any()


@pytest.mark.parametrize("b,s,h,d,kv_len,strided", [
    (2, 1000, 24, 128, 900, False),
    (1, 1408, 8, 128, None, True),
    (2, 320, 8, 64, 250, False),
], ids=["batch2_ragged_kv900", "strided", "d64_kv_len"])
def test_flash_backward_is_deterministic(b, s, h, d, kv_len, strided, cuda):
    """No atomics: each forward and dQ block owns its query rows and each
    dK/dV block its key rows, so a second launch on the same inputs gives the
    same bits (O and L of the forward, dQ, dK and dV); the forward without
    L gives the same O."""
    q, k, v, do = _flash_inputs(cuda, b, s, h, d, strided)
    lse = FA.flash_attention_lse(q, k, kv_len=kv_len)
    dvec = FA.attention_dvec(FA.flash_attention(q, k, v, kv_len=kv_len), do)
    first = (*FA.flash_attention_fwd(q, k, v, kv_len=kv_len),
             FA.flash_attention_dq(q, k, v, do, lse, dvec, kv_len=kv_len),
             *FA.flash_attention_dkv(q, k, v, do, lse, dvec, kv_len=kv_len))
    second = (*FA.flash_attention_fwd(q, k, v, kv_len=kv_len),
              FA.flash_attention_dq(q, k, v, do, lse, dvec, kv_len=kv_len),
              *FA.flash_attention_dkv(q, k, v, do, lse, dvec, kv_len=kv_len))
    without_lse = FA.flash_attention(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    assert torch.equal(first[0], without_lse)


def test_flash_function_gradients_on_the_card(cuda):
    """The autograd function on CUDA tensors (kernels) against the same
    function on the plain versions' composition; its backward takes the
    forward's L and launches no LSE pass."""
    q, k, v, do = _flash_inputs(cuda, 1, 1024, 8, 128, strided=False)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    lse_before = FA.flash_attention_lse.launches
    out = FlashAttention.apply(qg, kg, vg, 1000)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    assert FA.flash_attention_lse.launches == lse_before
    ref = FA.flash_attention_reference(q, k, v, kv_len=1000)
    lse = FA.flash_attention_lse_reference(q, k, kv_len=1000)
    dvec = FA.attention_dvec(ref, do)
    ref_grads = (FA.flash_attention_dq_reference(q, k, v, do, lse, dvec, kv_len=1000),
                 *FA.flash_attention_dkv_reference(q, k, v, do, lse, dvec, kv_len=1000))
    assert _rel(out, ref) <= BF16_TOL
    for g_, r_ in zip(grads, ref_grads):
        assert _rel(g_, r_) <= BF16_TOL


def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v, do = _flash_inputs(cuda, 1, 64, 2, 64, strided=False)
    with pytest.raises(TypeError, match="bfloat16"):
        FA.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="stride"):
        FA.flash_attention_lse(q.transpose(1, 2).contiguous().transpose(1, 2), k)
    lse = FA.flash_attention_lse(q, k)
    with pytest.raises(ValueError, match="float32"):
        FA.flash_attention_dq(q, k, v, do, lse.to(torch.bfloat16), lse)
    with pytest.raises(ValueError, match="kv_len"):
        FA.flash_attention_dkv(q, k, v, do, lse, lse, kv_len=65)


# ---------------------------------------------------------------------------
# quantised dense on the card
# ---------------------------------------------------------------------------

def _quant_linear(cuda, mode, d_in=3072, d_out=1536):
    from textflux_torch.io.quantize import QuantLinear

    g = torch.Generator(device=cuda).manual_seed(3)
    lin = torch.nn.Linear(d_in, d_out, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(d_out, d_in, generator=g, device=cuda) / d_in ** 0.5)
        lin.bias.copy_(torch.randn(d_out, generator=g, device=cuda))
    return QuantLinear.from_linear(lin, mode)


@pytest.mark.parametrize("rows", [1, 6, 1408])
def test_w8a8_dense_on_the_card_matches_the_cpu(rows, cuda):
    """w8a8 dense on the card (torch._int_mm; fewer than 17 rows padded)
    against the same call on the CPU. The int32 products of the same codes
    are equal bitwise. The per-token scale amax/127 may differ in its last
    bit between the two (CUDA divides by a scalar as a product with its
    reciprocal), so an activation that lands on a half rounds to the
    neighbouring code on one side: each such element moves an output by
    at most s * max|w| (one code of x times the largest weight), the
    tolerance below."""
    from textflux_torch.io.quantize import int_mm
    from textflux_torch.models.layers import dense

    q = _quant_linear(cuda, "w8a8")
    g = torch.Generator(device=cuda).manual_seed(4)
    xq = torch.randint(-127, 128, (rows, 3072), generator=g, device=cuda).to(torch.int8)
    assert torch.equal(int_mm(xq, q.w_q8a8).cpu(), int_mm(xq.cpu(), q.w_q8a8.cpu()))
    x = torch.randn(rows, 3072, generator=g, device=cuda, dtype=torch.float32)
    got = dense(q, x)
    want = dense(q.to("cpu"), x.cpu())
    assert got.shape == (rows, 1536)
    one_code = float(x.abs().amax() / 127 * (q.scale.amax() * 127))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=2 * one_code)


@pytest.mark.parametrize("mode", ["weight_only", "nf4"])
def test_quantized_dense_in_bf16_matches_the_dequantized_product(mode, cuda):
    """bf16 activations through the dequantise-on-read path against the
    float32 product with the float32 dequantised weight."""
    from textflux_torch.models.layers import dense

    q = _quant_linear(cuda, mode)
    x = torch.randn(2, 1408, 3072, generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda)
    got = dense(q, x.to(torch.bfloat16)).float()
    want = torch.nn.functional.linear(x, q.dequantize(torch.float32), q.bias.float())
    assert _rel(got, want) <= BF16_TOL


# ---------------------------------------------------------------------------
# the evaluation networks: the card (true float32, TF32 off inside the
# extractors) against the port on the CPU, same weights and inputs;
# tolerances as chip_smoke.py's eval phase: Inception pool3 within 1e-4 of
# the largest |feature|, LPIPS within 1e-4 relative, PP-OCR logits within
# 1e-4 absolute with the same decoded text
# ---------------------------------------------------------------------------

def _eval_net(name):
    import copy

    from textflux_torch.evaluation import inception as TI, lpips as TL, ppocr as TP

    g = torch.Generator().manual_seed(0)
    if name == "inception":
        model = TI.InceptionV3(device="cpu")
        model.load_state_dict(TI.convert_inception_state_dict(
            {k: v.numpy() for k, v in TI.random_torchvision_state_dict(g).items()}))
    elif name == "lpips":
        model = TL.LPIPS(device="cpu")
        model.load_state_dict(TL.convert_lpips_state_dict(
            {k: v.numpy() for k, v in TL.random_lpips_state_dict(g).items()}))
    else:
        cfg = TP.PPOCRConfig()
        model = TP.RecModel(cfg, device="cpu")
        model.load_state_dict(TP.convert_ppocr_state_dict(
            {k: v.numpy() for k, v in TP.random_recmodel_state_dict(cfg, g).items()}, cfg))
    return model.eval(), copy.deepcopy(model).to("cuda").eval()


@pytest.mark.parametrize("name", ["inception", "lpips", "ppocr"])
def test_eval_network_on_the_card_matches_the_cpu(name, cuda):
    from textflux_torch.evaluation import inception as TI, lpips as TL, ppocr as TP

    cpu, card = _eval_net(name)
    rng = np.random.default_rng(1)
    if name == "inception":
        x = rng.uniform(-1, 1, (4, 120, 160, 3)).astype(np.float32)
        ref, out = TI.make_fid_extractor(cpu)(x), TI.make_fid_extractor(card)(x)
        assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
    elif name == "lpips":
        a = rng.uniform(-1, 1, (4, 96, 128, 3)).astype(np.float32)
        b = np.clip(a + 0.3 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
        ref = TL.lpips_distance(cpu, a, b).numpy()
        out = TL.lpips_distance(card, a, b).cpu().numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-4)
    else:
        charset = ["sos"] + [chr(0x4E00 + i) for i in range(6623)] + [" "]
        for h, w in ((40, 150), (48, 320)):
            crop = rng.integers(0, 255, (h, w, 3), np.uint8)
            ref_rec, rec = TP.PPOCRRecognizer(cpu, charset), TP.PPOCRRecognizer(card, charset)
            np.testing.assert_allclose(rec.logits(crop), ref_rec.logits(crop), atol=1e-4)
            assert rec(crop) == ref_rec(crop)


def test_attn_mode_step_on_the_card_matches_the_cpu(cuda):
    """One --mode attn step (bf16 compute, AdamW; float32 masters beside
    bf16 frozen weights) of a small DiT (hidden 256: 2 heads of 128, one
    double and one single block; 16 text + 256 image tokens) on the card,
    through the flash kernels, against the same step through the plain
    versions on the CPU: the loss and every trainable parameter's gradient
    within 2e-2 of its largest |value|, the q/k norm scales' gradients
    (which flow out of dQ and dK through the plain RMSNorm and RoPE) finite
    and nonzero, and 4 / 0 / 2 / 2 launches."""
    from textflux_torch.config import FluxConfig, VAEConfig
    from textflux_torch.models.transformer import FluxTransformer
    from textflux_torch.models.vae import FluxVAE
    from textflux_torch.training import train as TR

    cfg = FluxConfig(in_channels=288, out_channels=16, num_double_layers=1, num_single_layers=1,
                     num_heads=2, head_dim=128, joint_dim=64, pooled_dim=32,
                     axes_dims_rope=(16, 56, 56))
    vae_cfg = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, latent_channels=4,
                        norm_num_groups=4, scaling_factor=0.5, shift_factor=0.1)
    g = torch.Generator().manual_seed(0)
    batch = {"pixel_values": torch.rand(1, 1, 256, 256, 3, generator=g) * 2 - 1,
             "mask": (torch.rand(1, 1, 256, 256, generator=g) > 0.7).float(),
             "txt": torch.randn(1, 1, 16, 64, generator=g),
             "pooled": torch.randn(1, 1, 32, generator=g)}
    noise = {"vae": torch.randn(1, 32, 32, 4, generator=g),
             "cond_vae": torch.randn(1, 32, 32, 4, generator=g),
             "u": torch.rand(1, generator=g), "noise": torch.randn(1, 32, 32, 4, generator=g)}
    tc = TR.TrainConfig(mode="attn")
    names = ("flash_attention", "flash_attention_lse", "flash_attention_dq",
             "flash_attention_dkv")
    out = {}
    for dev in ("cpu", "cuda"):
        gen = torch.Generator().manual_seed(1)
        flux = FluxTransformer(cfg, device="cpu", generator=gen).to(dev)
        vae = FluxVAE(vae_cfg, device="cpu", generator=gen).to(dev, torch.bfloat16)
        masks = TR.trainable_mask(flux, tc)
        TR.cast_params(flux, TR.mask_dtypes(masks, lambda name: torch.bfloat16))
        opt = TR.make_optimizer(tc, TR.freeze_to_mask(flux, masks), masks)
        before = [getattr(FA, x).launches for x in names]
        metrics = TR.make_train_step(tc)(flux, vae, opt, {k: v.to(dev) for k, v in batch.items()},
                                         noise=[{k: v.to(dev) for k, v in noise.items()}])
        launches = [getattr(FA, x).launches - b for x, b in zip(names, before)]
        out[dev] = (float(metrics["loss"]), launches,
                    {k: p.grad.float().cpu() for k, p in flux.named_parameters() if k in masks})
    (cpu_loss, _, cpu_grads), (loss, launches, grads) = out["cpu"], out["cuda"]
    assert launches == [4, 0, 2, 2]
    assert abs(loss - cpu_loss) <= BF16_TOL * abs(cpu_loss)
    assert set(grads) == set(cpu_grads) and len(grads) == 16
    for k, ref in cpu_grads.items():
        assert torch.isfinite(grads[k]).all(), k
        assert float((grads[k] - ref).abs().max()) <= BF16_TOL * float(ref.abs().max()), k
    scales = [k for k in grads if k.endswith(("q_scale", "k_scale"))]
    assert len(scales) == 6 and all(float(grads[k].abs().max()) > 0 for k in scales)


def test_gloo_collectives_fsdp_needs_on_the_card(cuda):
    """Two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one device)
    run the collectives FSDP2 calls on CUDA tensors: all_gather_into_tensor
    and reduce_scatter_tensor (chip_smoke.py's fsdp_train probe)."""
    import torch_dist_helpers as D

    n = 1 << 20
    with D.Ranks(D.gloo_cuda_collectives, 2, n) as ranks:
        results = ranks.results(timeout=120)
    for r in results:
        assert "error" not in r, r.get("error")
        np.testing.assert_array_equal(r["gathered"], np.repeat([1.0, 2.0], n))
        np.testing.assert_array_equal(r["reduced"], np.full(n, 3.0))
