"""The int8 weight-only linear on the CPU: the kernel's shape check against
every linear the int8 serving configuration quantises, the token tile it
picks, ``QuantLinear``'s weight_only path bitwise the plain expression it
has always run, and the autograd function's backward against autograd
through that expression. The kernel itself runs on the card
(``tests/test_torch_int8_matmul_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from textflux_torch.io.quantize import QuantLinear
from textflux_torch.ops import int8_matmul as IM

from torch_int8_shapes import W8_ROWS, W8_SHAPES, w8_config_shapes

H100_SMS = 132


def test_the_shape_list_is_the_w8_configurations():
    """W8_SHAPES (which the kernel's tests on the card also run) holds every
    (K, N) that quantize_tree makes of the w8 configuration's DiT and T5."""
    assert w8_config_shapes() == set(W8_SHAPES)


@pytest.mark.parametrize("k,n", W8_SHAPES, ids=[f"k{k}-n{n}" for k, n in W8_SHAPES])
def test_the_kernel_takes_each_w8_linear(k, n):
    """The wrapper's shape check accepts each linear at every token count the
    serving path meets, whole and as a tensor-parallel rank's half and
    quarter of its inputs (row-parallel) or outputs (column-parallel): a
    configuration whose linear the kernel would refuse fails here."""
    for m in W8_ROWS:
        for tp in (1, 2, 4):
            IM.check_shape(m, n // tp, k)
            IM.check_shape(m, n, k // tp)
            assert IM.token_tile(m, n // tp, H100_SMS) in IM.TOKEN_TILES


@pytest.mark.parametrize("m,n,k", [(0, 64, 64), (4, 64, 72), (4, 60, 64), (4, 64, 8)])
def test_the_shape_check_refuses_what_the_kernel_cannot_take(m, n, k):
    with pytest.raises(ValueError):
        IM.check_shape(m, n, k)


def test_the_token_tile_follows_the_rows():
    """One or 30 rows take the 32-token tile (no padding to 64); the T5 and
    text products (512 rows) a tile that fills the card in one wave; the
    chosen tile never costs more than any other by the wrapper's measure."""
    assert IM.token_tile(1, 18432, H100_SMS) == 32
    assert IM.token_tile(30, 3072, H100_SMS) == 32
    assert IM.token_tile(512, 4096, H100_SMS) == 128
    for m in W8_ROWS:
        for k, n in W8_SHAPES:
            t = IM.token_tile(m, n, H100_SMS)
            tiles = -(-n // IM.CHANNEL_TILE)
            cost = {u: -(-(tiles * -(-m // u)) // H100_SMS) * (u + IM.TILE_OVERHEAD)
                    for u in IM.TOKEN_TILES}
            assert cost[t] == min(cost.values())


def _quant_linear(k, n, bias, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    lin = nn.Linear(k, n, bias=bias).to(dtype)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(n, k, generator=g) * 0.05)
        if bias:
            lin.bias.copy_(torch.randn(n, generator=g))
    return QuantLinear.from_linear(lin, "weight_only")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_cpu_weight_only_is_the_plain_expression(dtype, bias):
    """On the CPU QuantLinear's weight_only product is bitwise the expression
    it ran before the kernel existed (the JAX package's dequantise on read):
    the codes cast to x's dtype times the scale cast, F.linear, then the
    bias in x's dtype; with bias=False (a row-parallel shard) no bias."""
    lin = _quant_linear(96, 40, bias, dtype)
    x = torch.randn(3, 5, 96, generator=torch.Generator().manual_seed(1)).to(dtype)
    w = lin.w_q.to(dtype) * lin.scale.to(dtype)[:, None]
    want = F.linear(x, w)
    if bias:
        want = want + lin.bias.to(dtype)
    before = IM.int8_matmul.launches
    assert torch.equal(lin.matmul(x), want)
    assert torch.equal(lin.matmul(x, bias=False), F.linear(x, w))
    assert IM.int8_matmul.launches == before    # the CPU never counts a launch


@pytest.mark.parametrize("bias", [True, False])
def test_autograd_backward_is_the_plain_expressions(bias):
    """Int8Matmul on CPU tensors (its forward then runs the plain version):
    the output and dx equal autograd through the plain expression."""
    lin = _quant_linear(64, 48, bias, torch.float32, seed=2)
    g = torch.Generator().manual_seed(3)
    x0 = torch.randn(7, 64, generator=g)
    dy = torch.randn(7, 48, generator=g)
    b = lin.bias if bias else None

    x1 = x0.clone().requires_grad_(True)
    y1 = IM.Int8Matmul.apply(x1, lin.w_q, lin.scale, b)
    y1.backward(dy)
    x2 = x0.clone().requires_grad_(True)
    y2 = IM.int8_matmul_reference(x2, lin.w_q, lin.scale, b)
    y2.backward(dy)
    assert torch.equal(y1, y2)
    assert torch.equal(x1.grad, x2.grad)


def test_the_launch_refuses_a_cpu_tensor():
    """`launch` is the kernel alone: it never falls back to the plain
    version."""
    lin = _quant_linear(64, 32, True, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        IM.launch(torch.zeros(2, 64, dtype=torch.bfloat16), lin.w_q, lin.scale, lin.bias)
