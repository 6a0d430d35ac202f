"""The port's conv3x3 + BatchNorm-statistics function
(maxstyle_tpu_torch/proto_conv_bn_fusion.py) against the JAX prototype
(scripts/proto_conv_bn_fusion.py, imported by file path).

At the prototype's ``check()`` shape (2, 32, 32, 16), the plain version
(what the wrapper runs on CPU tensors) is held against both
``conv3x3_bn_stats_xla`` and ``conv3x3_bn_stats_pallas(interpret=True)``
with ``check()``'s own tolerances: y rtol 1e-5 / atol 1e-5, mean rtol 1e-5 /
atol 1e-6, var rtol 1e-4 / atol 1e-5. The prototype is NHWC with HWIO
weights; the port is NCHW with [Cout, Cin, 3, 3] weights.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from maxstyle_tpu_torch import proto_conv_bn_fusion as P

torch.set_num_threads(2)

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "proto_conv_bn_fusion.py"


@pytest.fixture(scope="module")
def proto():
    spec = importlib.util.spec_from_file_location("proto_conv_bn_fusion_jax", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_inputs(shape=(2, 32, 32, 16), seed=0):
    """The inputs of the prototype's check(), in both layouts."""
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    w = (0.1 * rng.randn(3, 3, shape[-1], shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    port = (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
            torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
            torch.from_numpy(b))
    return (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), port


@pytest.mark.parametrize("arm", ["xla", "pallas_interpret"])
def test_plain_matches_the_prototype(proto, arm):
    jargs, targs = check_inputs()
    if arm == "xla":
        y0, m0, v0 = proto.conv3x3_bn_stats_xla(*jargs)
    else:
        y0, m0, v0 = proto.conv3x3_bn_stats_pallas(*jargs, interpret=True)
    y, m, v = P.conv3x3_bn_stats(*targs)
    assert y.shape == (2, 16, 32, 32) and m.shape == (16,) and v.dtype == torch.float32
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1), np.asarray(y0),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(m0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(v0), rtol=1e-4, atol=1e-5)


def test_plain_matches_the_library_arm_on_a_ragged_shape():
    """Cout != Cin and sides that are no multiple of the kernel's 16-pixel
    tile, against F.conv2d + torch.var_mean."""
    g = torch.Generator().manual_seed(3)
    x = torch.rand((3, 5, 19, 23), generator=g)
    w = 0.1 * torch.randn((7, 5, 3, 3), generator=g)
    b = 0.1 * torch.randn((7,), generator=g)
    got, want = P.conv3x3_bn_stats(x, w, b), P.conv_stats_library(x, w, b)
    assert P.compare(got, want)["worst"] <= 1.0


@pytest.mark.parametrize("shape", P.RAGGED_SHAPES)
def test_ragged_cases_of_the_entry_point(shape):
    """The (B, Cin, Cout, H, W) cases that --check and chip_smoke run on the
    card: the plain version agrees with the library arm on the CPU."""
    (x,), w, b = P.make_case(shape, 0, "cpu")
    assert tuple(x.shape) == (shape[0], shape[1], shape[3], shape[4])
    assert tuple(w.shape) == (shape[2], shape[1], 3, 3)
    got, want = P.conv3x3_bn_stats(x, w, b), P.conv_stats_library(x, w, b)
    assert P.compare(got, want)["worst"] <= 1.0


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits to the bit
    pattern (sign and magnitude, so this rounds the magnitude) and clear
    them."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(v: torch.Tensor):
    hi = _tf32_rna(v)
    return hi, _tf32_rna(v - hi)


def _conv_tf32(x, w, b, products: int):
    """The convolution with TF32 operands, as the kernel's tensor cores take
    them: one product (hi * hi) or the split's three (lo * hi + hi * lo +
    hi * hi). A product of two TF32 values is exact in float32, so the plain
    version's float32 contraction of the rounded operands is the product's
    emulation; the statistics follow from y as in the plain version. The
    sums here round to nearest; :func:`_conv_tensor_core_sums` models the
    tensor cores' accumulator."""
    (xh, xl), (wh, wl) = _split(x), _split(w)
    zero = torch.zeros_like(b)
    y = P.conv3x3_bn_stats_plain(xh, wh, zero)[0]
    if products == 3:
        y = P.conv3x3_bn_stats_plain(xl, wh, zero)[0] + P.conv3x3_bn_stats_plain(xh, wl, zero)[0] + y
    y = y + b[None, :, None, None]
    yd = y.double()
    n = y.shape[0] * y.shape[2] * y.shape[3]
    return (y, *P._stats(yd.sum(dim=(0, 2, 3)), (yd * yd).sum(dim=(0, 2, 3)), n))


def _trunc32(v: torch.Tensor) -> torch.Tensor:
    """float64 -> the float32 value next to it toward zero (kept as float64)."""
    f = v.float()
    f = torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()


def _conv_tensor_core_sums(x, w, b, grouped: bool):
    """The split's three products summed as the tensor cores sum them: each
    product instruction adds its 8-channel dot product (exact here) to a
    float32 accumulator that keeps the sum truncated toward zero. With
    ``grouped`` the accumulator starts from zero for the three taps of one
    column shift and chunk, and a float32 round-to-nearest addition takes
    each such sum, as the kernel does; without it one accumulator takes
    every tap of every chunk."""
    (xh, xl), (wh, wl) = _split(x), _split(w)
    bsz, cin, h, wd = x.shape
    xhp, xlp = F.pad(xh, (1, 1, 1, 1)).double(), F.pad(xl, (1, 1, 1, 1)).double()
    whd, wld = wh.double(), wl.double()
    acc = torch.zeros((bsz, w.shape[0], h, wd), dtype=torch.float64)
    for c0 in range(0, cin, 8):
        cs = slice(c0, c0 + 8)
        for dx in range(3):
            s = torch.zeros_like(acc) if grouped else acc
            for dy in range(3):
                th = xhp[:, cs, dy:dy + h, dx:dx + wd]
                tl = xlp[:, cs, dy:dy + h, dx:dx + wd]
                for xa, wb in ((tl, whd), (th, wld), (th, whd)):
                    s = _trunc32(s + torch.einsum("bihw,oi->bohw", xa, wb[:, cs, dy, dx]))
            acc = (acc.float() + s.float()).double() if grouped else s
    y = acc.float() + b[None, :, None, None]
    yd = y.double()
    return (y, *P._stats(yd.sum(dim=(0, 2, 3)), (yd * yd).sum(dim=(0, 2, 3)), bsz * h * wd))


@pytest.mark.parametrize("shape,one_accumulator_fails", [
    ((2, 32, 16), False), ((1, 192, 16), False), ((1, 96, 32), False), ((1, 48, 64), True)])
def test_tensor_core_accumulation_needs_the_grouped_sums(shape, one_accumulator_fails):
    """The kernel's summation design: with the tensor cores' truncating
    float32 accumulator, summing every tap in it biases the channel means
    out of tolerance at 64 input channels; the kernel's per-column-shift
    groups, added by rounding to nearest, stay within 0.5 of it at every
    shape."""
    (x,), w, b = P.make_case(shape, 0, "cpu")
    want = P.conv3x3_bn_stats_plain(x, w, b)
    grouped = P.compare(_conv_tensor_core_sums(x, w, b, True), want)
    single = P.compare(_conv_tensor_core_sums(x, w, b, False), want)
    assert grouped["worst"] <= 0.5, grouped
    assert single["worst"] > grouped["worst"], (single, grouped)
    if one_accumulator_fails:
        assert single["worst"] > 1.0, single


def test_tf32_rounding_emulation():
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12], dtype=torch.float32)
    want = [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    assert _tf32_rna(v).tolist() == want
    hi, lo = _split(torch.tensor([0.1], dtype=torch.float32))
    assert abs(float(hi) + float(lo) - 0.1) < 2.0 ** -22 * 0.1


@pytest.mark.parametrize("shape", [(2, 32, 16), (1, 192, 16), (1, 96, 32), (1, 48, 64)])
def test_split_tf32_meets_the_prototype_tolerances_and_one_product_does_not(shape):
    """The kernel's accuracy design: 3xTF32 within the prototype's check()
    tolerances with margin (worst <= 0.5), 1xTF32 outside them. The check()
    shape is (2, 32x32, 16); the bench's shapes run with B cut to 1."""
    (x,), w, b = P.make_case(shape, 0, "cpu")
    want = P.conv3x3_bn_stats_plain(x, w, b)
    three = P.compare(_conv_tf32(x, w, b, 3), want)
    one = P.compare(_conv_tf32(x, w, b, 1), want)
    assert three["worst"] <= 0.5, three
    assert one["worst"] > 1.0, one


def test_work_counts_and_tolerance_report():
    nbytes, ops = P.work((20, 192, 16))
    assert ops == 2 * 9 * 16 * 16 * 20 * 192 * 192 + 3 * 20 * 192 * 192 * 16
    assert nbytes == 4 * (2 * 20 * 192 * 192 * 16 + 9 * 256 + 16 + 32)
    # the tensor-core bound: bytes at 3.35 TB/s against three TF32 products
    # (2 * 9 * Cin * Cout a pixel each) at 495 TFLOP/s
    ms, by = P.bound((20, 192, 16))
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3) and round(ms * 1e3, 1) == 28.2
    ms, by = P.bound((20, 48, 64))
    assert by == "operations" and round(ms * 1e3, 1) == 20.6
    assert ms == pytest.approx(3 * 2 * 9 * 64 * 64 * 20 * 48 * 48 / 495e12 * 1e3)
    (x,), w, b = P.make_case((2, 16, 4), 0, "cpu")
    res = P.compare(P.conv3x3_bn_stats(x, w, b), P.conv3x3_bn_stats_plain(x, w, b))
    assert res["worst"] == 0.0 and set(res) >= {"y_worst", "mean_worst", "var_worst"}


def test_wrapper_refuses_non_cpu_tensors_and_entry_point_needs_a_gpu():
    x = torch.empty((1, 2, 4, 4), device="meta")
    w = torch.empty((2, 2, 3, 3), device="meta")
    b = torch.empty((2,), device="meta")
    with pytest.raises(ValueError):
        P.conv3x3_bn_stats(x, w, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            P.main(["--check"])
