"""The float32 linear layer's split-TF32 GEMM (ops/linear_kernels.py,
csrc/linear.cu) on the CPU: the kernel's arithmetic emulated against
float64, the autograd Function against ``F.linear`` bit for bit, the
products its backward asks for, the route by dtype and device, and the tile
plans. The kernel itself runs only on the card (chip_smoke.py, phase
``kernels``, rows ``linear_fwd``, ``linear_dx`` and ``linear_dw``)."""

import pytest
import torch
import torch.nn.functional as F

from maxstyle_tpu_torch import kernels
from maxstyle_tpu_torch.models import layers
from maxstyle_tpu_torch.ops import linear_kernels as LK

torch.set_num_threads(2)


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32, to nearest with ties away from zero (the kernel's
    integer rounding of the bit pattern)."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(v: torch.Tensor):
    hi = _tf32_rna(v)
    return hi, _tf32_rna(v - hi)


def _trunc32(v: torch.Tensor) -> torch.Tensor:
    """float64 -> the float32 value next to it toward zero (kept as float64):
    the tensor cores' accumulator."""
    f = v.float()
    f = torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()


def _kernel_sums(a, b, products=3, blocked=True):
    """C = a b^T as the kernel sums it: each product instruction adds an
    8-deep dot product of TF32 operands (exact in float64 here) to a float32
    accumulator that truncates. Within a k-block of 32 the small products
    (lo * hi and hi * lo of each step) come first, then hi * hi; with
    ``blocked`` the accumulator starts from zero each k-block and a float32
    round-to-nearest addition takes its sum, else one accumulator takes the
    whole contraction; ``products`` = 1 keeps hi * hi alone (plain TF32)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    k = a.shape[1]
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float64)
    part = torch.zeros_like(acc)

    def dot(x, y, step):
        s = slice(8 * step, 8 * step + 8)
        return x[:, s] @ y[:, s].T

    for k0 in range(0, -(-k // 8), 4):
        steps = range(k0, min(-(-k // 8), k0 + 4))
        if blocked:
            part = torch.zeros_like(acc)
        if products == 3:
            for step in steps:
                part = _trunc32(part + dot(al, bh, step))
                part = _trunc32(part + dot(ah, bl, step))
        for step in steps:
            part = _trunc32(part + dot(ah, bh, step))
        if blocked:
            acc = (acc.float() + part.float()).double()
    return (acc if blocked else part).float()


def _rel(c, ref):
    return float((c.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("k,one_accumulator_fails", [(48, False), (192, False), (768, True),
                                                     (3072, True)])
def test_split_tf32_blocks_meet_float32_and_one_product_or_one_accumulator_do_not(
        k, one_accumulator_fails):
    """At ViT-like (768, 3072) and Swin-like (48, 192) contractions, scaled
    down to 64 x 64 outputs: the kernel's scheme lies within twice a float32
    matmul's distance from float64; plain TF32 lies far outside at every
    contraction, and one truncating accumulator over the whole contraction
    outside at the ViT's."""
    gen = torch.Generator().manual_seed(k)
    a = torch.randn((64, k), generator=gen)
    b = torch.randn((64, k), generator=gen) / k ** 0.5
    ref = a.double() @ b.double().T
    tol = 2.0 * _rel(a @ b.T, ref)
    assert _rel(_kernel_sums(a, b), ref) <= tol
    assert _rel(_kernel_sums(a, b, products=1), ref) > 100 * tol
    one = _rel(_kernel_sums(a, b, blocked=False), ref)
    if one_accumulator_fails:
        assert one > tol


def test_tf32_split_emulation():
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11)])
    assert _tf32_rna(v).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    hi, lo = _split(torch.tensor([0.1]))
    assert abs(float(hi) - 0.1) <= 2.0 ** -11 * 0.1
    assert abs(float(hi) + float(lo) - 0.1) <= 2.0 ** -22 * 0.1


@pytest.mark.parametrize("shape", [(7, 16), (3, 5, 16)])
@pytest.mark.parametrize("bias", [True, False])
def test_function_on_cpu_equals_f_linear_bit_for_bit(shape, bias):
    gen = torch.Generator().manual_seed(len(shape) + bias)
    x = torch.randn(shape, generator=gen, requires_grad=True)
    w = torch.randn((12, 16), generator=gen, requires_grad=True)
    b = torch.randn(12, generator=gen, requires_grad=True) if bias else None
    leaves = [x, w] + ([b] if bias else [])
    y = LK.linear(x, w, b)
    want = F.linear(x, w, b)
    dy = torch.randn(want.shape, generator=gen)
    assert torch.equal(y, want)
    for got, ref in zip(torch.autograd.grad(y, leaves, dy), torch.autograd.grad(want, leaves, dy)):
        assert torch.equal(got, ref)


def _asked(take_grad, bias=True):
    LK.reset_asked()
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((4, 6, 16), generator=gen, requires_grad=True)
    w = torch.randn((8, 16), generator=gen, requires_grad=True)
    b = torch.randn(8, generator=gen, requires_grad=True) if bias else None
    take_grad(LK.linear(x * 2.0, w, b).square().sum(), x, w, b)
    return dict(LK.ASKED)


@pytest.mark.parametrize("bias", [True, False])
def test_backward_asks_for_dw_and_db_only_where_the_engine_uses_them(bias):
    """Under torch.autograd.grad with respect to the input (the MaxStyle
    inner loop's case: the weights require grad, but nothing accumulates
    into them) the backward computes dx alone; under .backward() all three;
    with respect to the weight alone, dW and no dx."""
    assert _asked(lambda loss, x, w, b: torch.autograd.grad(loss, x), bias) == \
        {"dx": 1, "dw": 0, "db": 0}
    assert _asked(lambda loss, x, w, b: loss.backward(), bias) == \
        {"dx": 1, "dw": 1, "db": int(bias)}
    assert _asked(lambda loss, x, w, b: torch.autograd.grad(loss, w), bias) == \
        {"dx": 0, "dw": 1, "db": 0}
    assert _asked(lambda loss, x, w, b: torch.autograd.grad(loss, (x, w)), bias) == \
        {"dx": 1, "dw": 1, "db": 0}
    assert _asked(lambda loss, x, w, b: loss.backward(inputs=[x]), bias) == \
        {"dx": 1, "dw": 0, "db": 0}


def test_backward_under_create_graph_raises():
    x = torch.randn((3, 4), requires_grad=True)
    w = torch.randn((2, 4), requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        torch.autograd.grad(LK.linear(x, w).sum(), x, create_graph=True)


@pytest.mark.parametrize("dtype,device,kernel", [
    (torch.float32, "cuda", True), (torch.float32, "cpu", False),
    (torch.bfloat16, "cuda", False), (torch.float16, "cuda", False),
    (torch.float64, "cuda", False)])
def test_route_by_compute_dtype_and_device(dtype, device, kernel):
    assert layers.kernel_route(dtype, torch.device(device)) is kernel


def test_a_bf16_compute_dtype_does_not_enter_the_function(monkeypatch):
    def refuse(*args):
        raise AssertionError("the linear Function was entered")

    monkeypatch.setattr(LK._Linear, "apply", refuse)
    lin = layers.Linear(16, 8)
    layers.set_compute_dtype(lin, torch.bfloat16)
    x = torch.randn((2, 16))
    y = lin(x)
    assert y.dtype is torch.bfloat16
    assert torch.equal(y, F.linear(x.bfloat16(), lin.weight.bfloat16(), lin.bias.bfloat16()))


# every Linear shape (tokens, in, out) of the UNETR and Swin-UNETR MaxStyle
# steps at batch 20: ViT-B/16's four; Swin's window attention at padded
# windows, its MLPs and mergings at each stage
STEP_SHAPES = [(2880, 768, 2304), (2880, 768, 768), (2880, 768, 3072), (2880, 3072, 768),
               (192080, 48, 144), (192080, 48, 48), (184320, 48, 192), (184320, 192, 48),
               (46080, 192, 96), (48020, 96, 288), (48020, 96, 96), (46080, 96, 384),
               (46080, 384, 96), (11520, 384, 192), (15680, 192, 576), (15680, 192, 192),
               (11520, 192, 768), (11520, 768, 192), (2880, 768, 384), (3920, 384, 1152),
               (3920, 384, 384), (2880, 384, 1536), (2880, 1536, 384), (720, 1536, 768)]


@pytest.mark.parametrize("m,k,n", STEP_SHAPES)
def test_plans_cover_each_product_once(m, k, n):
    """Every product's plan at the steps' shapes: a built tile width, and
    shares of the contraction that cover it once; only dW cuts it."""
    for p, q, r, can_split in ((m, n, k, False), (n, m, k, False), (m, k, n, False),
                               (k, m, n, False), (n, k, m, True)):
        columns, kb_per, seconds = LK.plan(p, q, r, 132, can_split)
        kb_total = -(-r // LK.BK)
        shares = -(-kb_total // kb_per)
        assert columns in LK.COLUMNS and seconds > 0
        assert shares <= LK.MAX_SPLITS and (shares - 1) * kb_per < kb_total <= shares * kb_per
        assert can_split or shares == 1


def test_plans_fill_the_card_at_the_vit_shapes():
    """The ViT's products run in waves at least 85% full on 132 SMs: the
    tile plan, not a model name, avoids a nearly empty last wave."""
    for m, k, n in STEP_SHAPES[:4]:
        for tokens, features, r in ((m, n, k), (m, k, n)):
            rows, columns, _ = LK._oriented(tokens, features, r, 132)
            p, q = (tokens, features) if rows else (features, tokens)
            tiles = -(-p // LK.ROWS) * -(-q // columns)
            assert tiles / (132 * -(-tiles // 132)) >= 0.85, (tokens, features, r)


def test_model_seconds_counts_bytes_and_operations():
    # bytes-bound: a skinny product moves A, B and C at the memory's rate
    nbytes = 4 * (184320 * 48 + 144 * 48 + 184320 * 144)
    assert LK.model_seconds(184320, 144, 48, 144, 2, 132) >= nbytes / LK.HBM_BYTES_PER_S
    # operations: 6 x 20 tiles of 128 x 144 fit one wave of 132
    per_kb = max(3 * 128 * 144 * 32 / LK.MACS_PER_CLOCK,
                 4 * (128 + 144) * 32 / LK.L2_BYTES_PER_CLOCK)
    clocks = 24 * (per_kb + LK.KB_CLOCKS) + LK.TILE_CLOCKS
    assert LK.model_seconds(768, 2880, 768, 144, 24, 132) == pytest.approx(clocks / LK.CLOCK_HZ)


@pytest.mark.parametrize("rows", [8, 7, 1])
def test_transposed_b_has_rows_of_a_multiple_of_4_values(rows):
    """The B operand that dW and dx hand in transposed: the values of t^T,
    its rows padded to a multiple of 4 values (the kernel's TMA rows)."""
    t = torch.randn(rows, 12)
    out = LK._transposed(t)
    assert out.shape == (12, -(-rows // 4) * 4) and out.is_contiguous()
    assert torch.equal(out[:, :rows], t.t())


def _emulated_gemm(c, a, a_mn, lda, b, ldb, p, q, r, sp, sq, columns, kb_per, bias=None,
                   bias_on_p=False, db=None):
    """linear_gemm's contract on CPU tensors, in float64: C(p, q) = sum_r
    A(p, r) B(q, r) (+ bias) at c[p sp + q sq], A at a[p lda + r] (a[r lda
    + p] with a_mn), B at b[q ldb + r], and db the row sums of A."""
    assert columns in LK.COLUMNS and kb_per >= 1
    A = a.as_strided((p, r), (1, lda) if a_mn else (lda, 1)).double()
    B = b.as_strided((q, r), (ldb, 1)).double()
    out = A @ B.T
    if bias is not None:
        out = out + (bias.double()[:, None] if bias_on_p else bias.double()[None, :])
    c.as_strided((p, q), (sp, sq)).copy_(out)
    if db is not None:
        db.copy_(A.sum(1))


@pytest.mark.parametrize("tokens_rows", [True, False])
@pytest.mark.parametrize("lead,k,n", [((6, 5), 12, 8), ((7,), 8, 12), ((2, 9), 16, 16)])
def test_the_wrappers_hand_the_kernel_each_product_s_operands(monkeypatch, tokens_rows, lead,
                                                              k, n):
    """The wrappers' strides, orientations and transposed copies, held to the
    kernel's contract by an emulation of it: y, dx and (dW, db) equal the
    float64 products with the tokens as C's rows or columns, dW with x^T or
    dy^T as B (n > k or n < k), and token counts that are not a multiple
    of 4."""
    monkeypatch.setattr(LK, "_gemm", _emulated_gemm)
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES, 0))
    monkeypatch.setattr(LK, "sm_count", lambda dev: 132)
    monkeypatch.setattr(LK, "_oriented", lambda *shape: (tokens_rows, 48, 1))
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((*lead, k), generator=gen, dtype=torch.float64).float()
    w = torch.randn((n, k), generator=gen, dtype=torch.float64).float()
    b = torch.randn(n, generator=gen, dtype=torch.float64).float()
    dy = torch.randn((*lead, n), generator=gen, dtype=torch.float64).float()
    x64, w64, dy64 = x.double(), w.double(), dy.double()
    torch.testing.assert_close(LK._fwd(x, w, b), (x64 @ w64.T + b.double()).float())
    torch.testing.assert_close(LK._dx(dy, w), (dy64 @ w64).float())
    dw, db = LK._dw(dy, x, True)
    torch.testing.assert_close(dw, (dy64.reshape(-1, n).T @ x64.reshape(-1, k)).float())
    torch.testing.assert_close(db, dy64.reshape(-1, n).sum(0).float())
    assert LK._dw(dy, x, False)[1] is None
