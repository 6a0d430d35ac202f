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


def test_work_counts_and_tolerance_report():
    nbytes, ops = P.work((20, 192, 16))
    assert ops == 2 * 9 * 16 * 16 * 20 * 192 * 192 + 3 * 20 * 192 * 192 * 16
    assert nbytes == 4 * (2 * 20 * 192 * 192 * 16 + 9 * 256 + 16 + 32)
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
