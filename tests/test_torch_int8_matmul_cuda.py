"""The int8 weight-only kernel (csrc/w8a16_gemm_sm90.cu) on the card.

At every (K, N) of the int8 serving configuration's DiT and T5 linears
(``torch_int8_shapes.W8_SHAPES``) and every token count the serving path
meets (``W8_ROWS``), with and without the bias and at a tensor-parallel
rank's half of the inputs and of the outputs, the kernel is held to

  * a float32 product of the dequantised weight, within one bf16 place of
    the output: the kernel multiplies the exact bf16 codes by bf16 x in
    fp32, applies the fp32 scale and the bias in fp32 and rounds once;
  * the plain version (weight rounded to bf16, output rounded, bias added
    in bf16), within BF16_REL relative L2: the plain path's two extra
    roundings are the difference.

Besides: every token tile alike, two launches bitwise equal, one call
captured in a CUDA graph replays bitwise its eager result, ``launches``
counts each call (QuantLinear's weight_only path and the autograd
function's included), and the autograd function's dx is the plain
expression's. These tests carry the ``cuda`` marker and skip without a CUDA
device:

    python -m pytest tests/test_torch_int8_matmul_cuda.py -m cuda -q --noconftest
"""

import pytest
import torch
import torch.nn.functional as F

from textflux_torch.io.quantize import QuantLinear
from textflux_torch.ops import int8_matmul as IM

from torch_int8_shapes import W8_ROWS, W8_SHAPES

pytestmark = pytest.mark.cuda

ULP = 2.0 ** -8          # one bf16 place, relative (8 significant bits)
BF16_REL = 1e-2          # the plain path rounds the weight and the output to bf16


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(k, n, cuda, seed=0):
    """Codes in [-127, 127], per-channel scales of a weight of std ~0.02, a
    bf16 bias."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    w_q = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    scale = (0.06 + 0.02 * torch.rand(n, generator=g, device=cuda)) / 127.0
    bias = torch.randn(n, generator=g, device=cuda).to(torch.bfloat16)
    return w_q, scale, bias


def _x(m, k, cuda, seed=1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)


def _check(x, w_q, scale, bias):
    """The kernel against the float32 product and the plain version."""
    out = IM.launch(x, w_q, scale, bias)
    torch.cuda.synchronize()
    ref = x.float() @ (w_q.float() * scale[:, None]).t()
    if bias is not None:
        ref = ref + bias.float()
    err = (out.float() - ref).abs()
    # one place of the output, plus fp32 sums taken in another order
    tol = ULP * ref.abs() + 1e-4 * ref.abs().max()
    assert bool((err <= tol).all()), f"max err {err.max().item()} / {ref.abs().max().item()}"
    plain = IM.int8_matmul_reference(x, w_q, scale, bias).float()
    rel = ((out.float() - plain).norm() / plain.norm()).item()
    assert rel < BF16_REL, rel


@pytest.mark.parametrize("k,n", W8_SHAPES, ids=[f"k{k}-n{n}" for k, n in W8_SHAPES])
def test_kernel_matches_float32_and_plain(k, n, cuda):
    w_q, scale, bias = _operands(k, n, cuda)
    for m in W8_ROWS:
        x = _x(m, k, cuda, seed=m)
        _check(x, w_q, scale, bias)
        _check(x, w_q, scale, None)
        # a tp = 2 rank: row-parallel (half the inputs, no bias), and
        # column-parallel (half the outputs, with their bias)
        _check(x[:, :k // 2].contiguous(), w_q[:, :k // 2].contiguous(), scale, None)
        _check(x, w_q[n // 2:].contiguous(), scale[n // 2:].contiguous(),
               bias[n // 2:].contiguous())


@pytest.mark.parametrize("tile", IM.TOKEN_TILES)
def test_every_token_tile(tile, cuda):
    """Each instantiation, at ragged M, N and K edges and over several
    persistent tiles a block, gives the float32 product within a place."""
    k, n = 3072 + 48, 3072 + 72     # K past a 64-wide stage, N past a 128-wide tile
    w_q, scale, bias = _operands(k, n, cuda, seed=tile)
    for m in (1, 77, 1000):
        x = _x(m, k, cuda, seed=m)
        out = IM.launch(x, w_q, scale, bias, tile=tile)
        ref = x.float() @ (w_q.float() * scale[:, None]).t() + bias.float()
        err = (out.float() - ref).abs()
        assert bool((err <= ULP * ref.abs() + 1e-4 * ref.abs().max()).all())


def test_two_launches_are_bitwise_equal(cuda):
    w_q, scale, bias = _operands(3072, 21504, cuda)
    x = _x(1408, 3072, cuda)
    assert torch.equal(IM.launch(x, w_q, scale, bias), IM.launch(x, w_q, scale, bias))


def test_a_graph_replay_is_the_eager_call(cuda):
    """One call captured in a CUDA graph: its replay writes bitwise the eager
    result, on new inputs copied into the captured buffer too."""
    w_q, scale, bias = _operands(15360, 3072, cuda)
    x = _x(1216, 15360, cuda)
    eager = IM.launch(x, w_q, scale, bias)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        IM.launch(x, w_q, scale, bias)       # warm-up off the default stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = IM.launch(x, w_q, scale, bias)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x2 = _x(1216, 15360, cuda, seed=9)
    x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, IM.launch(x2, w_q, scale, bias))


def test_launches_count_every_call(cuda):
    """The counter counts the wrapper's calls, QuantLinear's weight_only
    product and the autograd path's forward; a graph replay is no call."""
    lin = QuantLinear(3072, 9216, "weight_only", device=cuda)
    w_q, scale, bias = _operands(3072, 9216, cuda)
    lin.w_q.copy_(w_q)
    lin.scale.copy_(scale)
    lin.bias.copy_(bias)
    x = _x(512, 3072, cuda).reshape(2, 256, 3072)
    before = IM.int8_matmul.launches
    with torch.inference_mode():
        y = lin.matmul(x)
        y_nb = lin.matmul(x, bias=False)
    assert IM.int8_matmul.launches == before + 2
    assert y.shape == (2, 256, 9216)
    assert torch.equal(y, IM.launch(x, w_q, scale, bias))
    assert torch.equal(y_nb, IM.launch(x, w_q, scale, None))
    assert IM.int8_matmul.launches == before + 4

    # a gradient through the kernel's forward: dx is the plain expression's
    xg = x.detach().clone().requires_grad_(True)
    yg = lin.matmul(xg)
    assert IM.int8_matmul.launches == before + 5
    assert torch.equal(yg.detach(), y)
    dy = torch.randn_like(yg)
    yg.backward(dy)
    xr = x.detach().clone().requires_grad_(True)
    F.linear(xr, w_q.to(torch.bfloat16) * scale.to(torch.bfloat16)[:, None]).backward(dy)
    # the same product of the same bf16 operands; cuBLAS may pick another
    # algorithm for the folded and the batched call (bitwise on the CPU)
    rel = ((xg.grad.float() - xr.grad.float()).norm() / xr.grad.float().norm()).item()
    assert rel < 1e-3, rel


def test_the_wrapper_raises_on_what_the_kernel_cannot_take(cuda):
    w_q, scale, bias = _operands(64, 64, cuda)
    with pytest.raises(TypeError):
        IM.launch(_x(4, 64, cuda).float(), w_q, scale, bias)
    with pytest.raises(ValueError):     # K = 60: not a multiple of 16
        IM.launch(_x(4, 60, cuda), w_q[:, :60].contiguous(), scale, bias)
