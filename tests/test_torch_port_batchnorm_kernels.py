"""The BatchNorm kernel pair's CPU side (``ops/batchnorm_kernels``).

The plain versions (what the wrappers run on CPU tensors, and what the CUDA
kernels are held to on the card) against ``F.batch_norm`` in float64 and
float32: the output, the running statistics a "train" pass leaves, and the
three gradients, over 2-D, 3-D, 4-D and 5-D inputs in both modes; the same
through the autograd Function. ``plan``, a pure function, against the
cluster capacity of an H100 (as CUDA's occupancy calculator reported it on
the card) and a uniform one. ``models/layers.BatchNorm`` keeps
``F.batch_norm`` for CPU tensors and sends only the "train" and "frozen"
passes of a CUDA tensor to the kernels. Inputs come from a numpy seed.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from maxstyle_tpu_torch.models import layers
from maxstyle_tpu_torch.ops import batchnorm_kernels as bk

EPS, MOMENTUM = 1e-5, 0.1
# clusters of k = 1..16 blocks that an H100 SXM runs at once, at the
# kernels' 512 threads and 96 KB of shared memory a block
H100_CAPACITY = (264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14, 14, 14)
UNIFORM_CAPACITY = tuple(264 // k for k in range(1, 17))

SHAPES = {"2d": (6, 3), "3d": (4, 3, 10), "4d": (3, 4, 5, 7), "5d": (2, 3, 2, 3, 4)}


def _case(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    c = shape[1]
    offset = (1.0 + 3.0 * rng.randn(c)).reshape((1, c) + (1,) * (len(shape) - 2))
    as_t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return (as_t(rng.randn(*shape) * 2.0 + offset), as_t(1.0 + 0.1 * rng.randn(c)),
            as_t(0.1 * rng.randn(c)), as_t(0.1 * rng.randn(c)), as_t(1.0 + 0.1 * rng.rand(c)),
            as_t(rng.randn(*shape)))


def _reference(x, w, b, rm, rv, dy, mode):
    """F.batch_norm's output, running buffers and three gradients."""
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    rm, rv = rm.clone(), rv.clone()
    if mode == "train":
        y = F.batch_norm(xr, rm, rv, wr, br, True, MOMENTUM, EPS)
    else:
        y = F.batch_norm(xr, None, None, wr, br, True, 0.0, EPS)
    y.backward(dy)
    return y.detach(), rm, rv, (xr.grad, wr.grad, br.grad)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["train", "frozen"])
@pytest.mark.parametrize("dims", sorted(SHAPES))
def test_plain_versions_match_f_batch_norm(dims, mode, dtype):
    x, w, b, rm, rv, dy = _case(SHAPES[dims], dtype, seed=len(dims) + len(mode))
    y_ref, rm_ref, rv_ref, grads_ref = _reference(x, w, b, rm, rv, dy, mode)
    run = (rm.clone(), rv.clone()) if mode == "train" else (None, None)
    y, stats = bk.batch_norm_fwd(x, w, b, *run, MOMENTUM if mode == "train" else 0.0, EPS)
    torch.testing.assert_close(y, y_ref)
    if mode == "train":
        torch.testing.assert_close(run[0], rm_ref)
        torch.testing.assert_close(run[1], rv_ref)
    var, mean = torch.var_mean(x, dim=bk._dims(x), unbiased=False)
    torch.testing.assert_close(stats, torch.stack([mean, 1.0 / torch.sqrt(var + EPS)]))
    grads = bk.batch_norm_bwd(dy, x, w, stats)
    for got, want in zip(grads, grads_ref):
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("mode", ["train", "frozen"])
def test_autograd_function_matches_f_batch_norm(mode):
    x, w, b, rm, rv, dy = _case(SHAPES["4d"], torch.float64, seed=3)
    y_ref, rm_ref, rv_ref, grads_ref = _reference(x, w, b, rm, rv, dy, mode)
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    run = (rm.clone(), rv.clone()) if mode == "train" else (None, None)
    y = bk.batch_norm(xr, wr, br, *run, MOMENTUM if mode == "train" else 0.0, EPS)
    torch.testing.assert_close(y, y_ref)
    if mode == "train":
        torch.testing.assert_close(run[0], rm_ref)
        torch.testing.assert_close(run[1], rv_ref)
    for got, want in zip(torch.autograd.grad(y, (xr, wr, br), dy), grads_ref):
        torch.testing.assert_close(got, want)


def test_autograd_function_skips_what_needs_no_gradient_and_refuses_double_backward():
    x, w, b, _, _, dy = _case(SHAPES["3d"], torch.float64, seed=5)
    xr = x.clone().requires_grad_(True)
    y = bk.batch_norm(xr, w, b, None, None, 0.0, EPS)
    (dx,) = torch.autograd.grad(y, xr, dy)
    torch.testing.assert_close(dx, _reference(x, w, b, w, w, dy, "frozen")[3][0])
    y = bk.batch_norm(xr, w, b, None, None, 0.0, EPS)
    with pytest.raises(RuntimeError, match="not differentiable"):
        torch.autograd.grad(y, xr, dy, create_graph=True)
    assert bk.batch_norm_bwd_plain(dy, x, w, bk.batch_norm_fwd(x, w, b, None, None, 0.0,
                                                              EPS)[1],
                                   need_dx=False)[0] is None


# (C, values a channel): both training cells' BatchNorms at batch 20, the
# Prostate stem, UNETR's 768-channel projections, the 3-D family, ragged
PLAN_CASES = {
    "c16_192sq": (16, 20 * 192 * 192), "c32_96sq": (32, 20 * 96 * 96),
    "c64_48sq": (64, 20 * 48 * 48), "c128_24sq": (128, 20 * 24 * 24),
    "c128_12sq": (128, 20 * 12 * 12), "prostate_c16_224sq": (16, 20 * 224 * 224),
    "unetr_c768_12sq": (768, 20 * 12 * 12), "c1_192sq": (1, 20 * 192 * 192),
    "blocks3d_c8": (8, 2 * 16 * 32 * 32), "ragged_c5": (5, 3 * 7 * 9),
    "ragged_c3_odd": (3, 4 * 1001 * 13), "two_values": (7, 2), "c300": (300, 20 * 48 * 48),
}


@pytest.mark.parametrize("capacity", [H100_CAPACITY, UNIFORM_CAPACITY], ids=["h100", "uniform"])
@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan_covers_each_channel_once_in_one_wave(name, capacity):
    c, m = PLAN_CASES[name]
    k, per_rank = bk.plan(c, m, capacity)
    assert 1 <= k <= bk.MAX_CLUSTER == 16
    assert per_rank % 4 == 0 and per_rank > 0
    covered = np.zeros(m, dtype=np.int64)
    for r in range(k):
        covered[r * per_rank:min(m, (r + 1) * per_rank)] += 1
    assert (covered == 1).all()
    if k > 1:
        assert c <= capacity[k - 1]
        assert m >= k * bk.MIN_RANK_VALUES
    allowed = [s for s in range(1, 17)
               if s == 1 or (c <= capacity[s - 1] and m >= s * bk.MIN_RANK_VALUES)]
    if max(c * s for s in allowed) >= 132:
        assert c * k >= 132
    assert k == max(allowed)


def test_plan_at_the_training_cells_shapes_on_an_h100():
    got = {name: bk.plan(*PLAN_CASES[name], H100_CAPACITY)[0]
           for name in ("c16_192sq", "c32_96sq", "c64_48sq", "c128_24sq", "c128_12sq",
                        "unetr_c768_12sq")}
    assert got == {"c16_192sq": 12, "c32_96sq": 7, "c64_48sq": 3, "c128_24sq": 2,
                   "c128_12sq": 1, "unetr_c768_12sq": 1}


def test_wrappers_refuse_tensors_the_kernels_do_not_take():
    meta = torch.empty((2, 3, 4, 4), device="meta")
    one = torch.empty((3,), device="meta")
    with pytest.raises(ValueError):
        bk.batch_norm_fwd(meta, one, one, None, None, 0.0, EPS)
    with pytest.raises(ValueError):
        bk.batch_norm_bwd(meta, meta, one, torch.empty((2, 3), device="meta"))


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it is on a CUDA device, to follow the route."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True


def _routes(monkeypatch, norm, x, mode):
    """Which of F.batch_norm and the kernels' batch_norm one pass calls."""
    calls = []
    real = F.batch_norm

    def via_f(*a, **kw):
        calls.append(("F", a[1] is not None))
        return real(*a, **kw)

    def via_kernels(x, weight, bias, running_mean, running_var, momentum, eps):
        calls.append(("kernels", running_mean is not None))
        return x.as_subclass(torch.Tensor)

    monkeypatch.setattr(layers.F, "batch_norm", via_f)
    monkeypatch.setattr(layers.batchnorm_kernels, "batch_norm", via_kernels)
    norm(x, mode)
    return calls


@pytest.mark.parametrize("mode", ["train", "frozen", "eval"])
def test_batchnorm_keeps_f_batch_norm_for_cpu_tensors(monkeypatch, mode):
    norm = layers.BatchNorm(3)
    x, *_ = _case((4, 3, 5, 5), torch.float32, seed=7)
    assert _routes(monkeypatch, norm, x, mode) == [("F", mode != "frozen")]


@pytest.mark.parametrize("mode", ["train", "frozen", "eval"])
def test_batchnorm_sends_train_and_frozen_of_a_cuda_tensor_to_the_kernels(monkeypatch, mode):
    norm = layers.BatchNorm(3)
    x, *_ = _case((4, 3, 5, 5), torch.float32, seed=8)
    fake = x.as_subclass(_FakeCuda)
    want = {"train": [("kernels", True)], "frozen": [("kernels", False)],
            "eval": [("F", True)]}[mode]
    assert _routes(monkeypatch, norm, fake, mode) == want


def test_batchnorm_update_experiment_and_live_route_stay_off_the_kernels(monkeypatch):
    norm = layers.BatchNorm(3)
    x, *_ = _case((4, 3, 5, 5), torch.float32, seed=9)
    fake = x.as_subclass(_FakeCuda)
    monkeypatch.setattr(layers, "_BN_UPDATE_MODE", "torch")
    assert _routes(monkeypatch, norm, fake, "train") == [("F", False)]
    monkeypatch.setattr(layers, "_BN_UPDATE_MODE", None)
    with layers.live_running_stats(norm):
        assert _routes(monkeypatch, norm, fake, "train") == []


def test_layout_names_the_two_memory_orders_the_kernels_take():
    x4 = torch.zeros((2, 3, 4, 5))
    x5 = torch.zeros((2, 3, 4, 5, 6))
    assert bk._layout(x4) is torch.contiguous_format
    assert bk._layout(x4.contiguous(memory_format=torch.channels_last)) is torch.channels_last
    assert bk._layout(x5.contiguous(memory_format=torch.channels_last_3d)) \
        is torch.channels_last_3d
    assert bk._layout(x4.transpose(2, 3)) is None
    assert bk._layout(torch.zeros((4, 3, 5)).transpose(0, 2)) is None


@pytest.mark.parametrize("order", ["channels_last", "transposed"])
def test_batch_norm_keeps_channels_last_and_copies_other_orders(order):
    x, w, b, rm, rv, dy = _case((3, 4, 5, 6), torch.float64, seed=11)
    if order == "channels_last":
        x, dy = (t.contiguous(memory_format=torch.channels_last) for t in (x, dy))
    else:
        x, dy = (t.transpose(2, 3).contiguous().transpose(2, 3) for t in (x, dy))
    y_ref, rm_ref, rv_ref, grads_ref = _reference(x, w, b, rm, rv, dy, "train")
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))  # clone keeps the order
    run = (rm.clone(), rv.clone())
    y = bk.batch_norm(xr, wr, br, *run, MOMENTUM, EPS)
    torch.testing.assert_close(y, y_ref)
    torch.testing.assert_close(run[0], rm_ref)
    torch.testing.assert_close(run[1], rv_ref)
    if order == "channels_last":
        assert y.is_contiguous(memory_format=torch.channels_last)
    for got, want in zip(torch.autograd.grad(y, (xr, wr, br), dy), grads_ref):
        torch.testing.assert_close(got, want)
