"""The gradient bar of the port's model-family tests, and its own checks.

A module's float32 gradients through stacks of BatchNorms over a few values
a channel lie up to a few 1e-2 of its largest gradient away from float64,
on both sides (measured on the STN's image encoder at 64x64: 3.2e-2 for the
port, 3.3e-2 for JAX). A fixed elementwise floor wide enough for that
would let a port fault of the same size pass. So each module's gradients
are held four ways, with ``gmax`` the module's largest float64 gradient
and ``jax_dist`` JAX's own float32-from-float64 distance, the largest over
the module's tensors:

1. the port's float64 gradient against JAX's float64 one, each tensor at
   1e-6 of ``gmax`` (the semantics: a port fault shows here at float64's
   resolution; measured up to 6.0e-8 over the STN, Unet and DS_FCN tests:
   both sides compute their losses in float32, nothing else rounds so);
2. the port's float32 against its own float64, each tensor within 6x
   ``jax_dist`` plus 1e-4 of ``gmax`` (measured up to 4.15x, the STN's
   shape decoder: which side rounds further varies module by module);
3. the port's float32 against JAX's float32, each tensor within 7x
   ``jax_dist`` plus 1e-4 of ``gmax`` (the triangle of 1 and 2; measured up
   to 4.04x);
4. the whole module's float32 gradient with cosine > 0.999.

Bars 2 and 3 assume that float32 rounding moves no pre-activation across
a LeakyReLU's or ReLU's kink: one that lies within rounding of zero takes
the other slope in one precision, and every gradient behind it moves by a
finite step that no rounding distance bounds. A test that meets such a
crossing raises their floor, says by how much and why, and keeps bars 1
and 4.

JAX's float64 run is ``jax.enable_x64(True)`` with the float32 casts of
the JAX package's BatchNorm and instance norm (``models/layers.py``,
``ops/intensity.py``) lifted to float64 for the duration: the JAX package
computes normalization statistics in float32 by design, so without the lift
its "float64" run would keep the very rounding under measure. The lift
replaces those modules' ``jnp`` name by a view whose ``float32`` is
``float64``, and puts it back on exit; no file of the JAX package changes.
The port's float64 run is a float64 copy of its modules under float64 as
torch's default dtype.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu_torch import convert

SEMANTICS_BAR = 1e-6
PORT_FACTOR, GAP_FACTOR, FLOOR = 6.0, 7.0, 1e-4
COSINE = 0.999


class _Float64View:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(self._module, name)


@contextlib.contextmanager
def jax_float64():
    """JAX in float64, the JAX package's normalization casts included."""
    from maxstyle_tpu.models import layers as jl
    from maxstyle_tpu.ops import intensity as ji

    lifted = (jl, ji)
    with jax.enable_x64(True):
        for m in lifted:
            m.jnp = _Float64View(jnp)
        try:
            yield
        finally:
            for m in lifted:
                m.jnp = jnp


@contextlib.contextmanager
def torch_default_dtype(dtype):
    before = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(before)


def _grads(nets):
    return {name: {k: (torch.zeros_like(p) if p.grad is None else p.grad).double()
                   for k, p in module.named_parameters()} for name, module in nets.items()}


def port_grads(nets, run):
    """{module: {param: float64 tensor}} of the port's gradients in float32
    and float64: ``run(nets, dtype)`` computes a loss on a copy of ``nets``
    in ``dtype`` (inputs cast to it) and calls backward."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        copy_ = copy.deepcopy(nets).to(dtype)
        for p in copy_.parameters():
            p.grad = None
        with torch_default_dtype(dtype):
            run(copy_, dtype)
        out[dtype] = _grads(copy_)
    return out[torch.float32], out[torch.float64]


def jax_grads(grad_fn, params, grads32=None):
    """JAX's gradients in float32 and float64, converted to the port's
    names: ``grad_fn(params, dtype)`` returns the gradient tree of params
    cast to ``dtype`` (inputs cast to it); ``grads32``, when the caller has
    the float32 tree already, stands for the float32 call."""
    def converted(tree, np_dtype):
        g = jax.tree_util.tree_map(lambda a: np.array(a, np_dtype), tree)
        conv = convert.convert_train_state(g, {})
        return {n: {k: v.double() for k, v in sd.items()} for n, sd in conv.items()}

    def cast(dtype):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)

    g32 = converted(grads32 if grads32 is not None else grad_fn(cast(jnp.float32), jnp.float32),
                    np.float32)
    with jax_float64():
        g64 = converted(grad_fn(cast(jnp.float64), jnp.float64), np.float64)
    return g32, g64


def bar_excess(got32, got64, want32, want64, floor=FLOOR):
    """{check: (worst excess over its bar, where)} of one module's
    gradients; an excess > 0 fails the check (module docstring)."""
    gmax = max(float(w.abs().max()) for w in want64.values())
    jax_dist = max(float((want32[k] - w).abs().max()) for k, w in want64.items())
    worst = {"semantics": (-np.inf, ""), "port": (-np.inf, ""), "gap": (-np.inf, "")}

    def note(check, excess, key):
        if excess > worst[check][0]:
            worst[check] = (excess, key)

    ours, theirs = [], []
    for key, w64 in want64.items():
        t32, t64, w32 = got32[key], got64[key], want32[key]
        note("semantics", float((t64 - w64).abs().max()) - SEMANTICS_BAR * gmax, key)
        note("port", float((t32 - t64).abs().max()) - (PORT_FACTOR * jax_dist + floor * gmax),
             key)
        note("gap", float((t32 - w32).abs().max()) - (GAP_FACTOR * jax_dist + floor * gmax),
             key)
        ours.append(t32.flatten())
        theirs.append(w32.flatten())
    a, b = torch.cat(ours), torch.cat(theirs)
    worst["cosine"] = (COSINE - float(a @ b / (a.norm() * b.norm() + 1e-30)), "")
    return worst


def assert_grads_match(port, jax_side, floor=FLOOR):
    """``port`` = port_grads(...), ``jax_side`` = jax_grads(...): every
    module's gradients at the four bars of the module docstring; ``floor``
    replaces the float32 bars' 1e-4 where a caller states why."""
    (p32, p64), (j32, j64) = port, jax_side
    assert set(p32) == set(j32), (sorted(p32), sorted(j32))
    for name in j32:
        assert set(p32[name]) == set(j32[name]), name
        for check, (excess, key) in bar_excess(p32[name], p64[name], j32[name],
                                               j64[name], floor).items():
            assert excess <= 0, f"{name}.{key}: the {check} bar is exceeded by {excess:.3e}"


# ---------------------------------------------------------------------------
# the bar's own checks, on one BatchNorm block at a conditioning like the
# families' deepest layers (8 values a channel)
# ---------------------------------------------------------------------------

def _block():
    from maxstyle_tpu.models import layers as jl
    from maxstyle_tpu_torch.models import layers as tl

    rng = np.random.RandomState(0)
    x = (rng.randn(2, 2, 2, 6) + 3.0).astype(np.float32)
    g = rng.randn(2, 2, 2, 6).astype(np.float32)
    mod = jl.Norm2d("batch")
    variables = mod.init(jax.random.key(0), jnp.asarray(x), train=False)
    params = {"norm": jax.tree_util.tree_map(np.asarray, variables["params"])}
    nets = torch.nn.ModuleDict({"norm": tl.Norm2d("batch", 6)})
    nets["norm"].load_state_dict(convert.flax_to_state_dict(
        params["norm"], jax.tree_util.tree_map(np.asarray, variables["batch_stats"])))

    def port_run(n, dtype):
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype)
        out = n["norm"](xt * xt, "train")
        (out * torch.from_numpy(g.transpose(0, 3, 1, 2).copy()).to(dtype)).sum().backward()

    def jax_grad(p, dtype):
        def loss(p):
            out = mod.apply({"params": p["norm"], "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x, dtype) ** 2, train=True, mutable=["batch_stats"])[0]
            return jnp.sum(out * jnp.asarray(g, dtype))
        return jax.grad(loss)(p)

    return nets, params, port_run, jax_grad


def test_the_lift_runs_jax_batchnorm_in_float64_and_restores_it():
    from maxstyle_tpu.models import layers as jl

    x = jnp.asarray(np.random.RandomState(1).randn(2, 3, 3, 4))
    mod = jl.Norm2d("batch")
    with jax_float64():
        v = mod.init(jax.random.key(0), jnp.asarray(x, jnp.float64), train=False)
        out, _ = mod.apply(v, jnp.asarray(x, jnp.float64), train=True, mutable=["batch_stats"])
        assert out.dtype == jnp.float64
    assert jl.jnp is jnp
    assert jax.numpy.zeros(()).dtype == jnp.float32  # x64 is off again


def test_the_bar_passes_the_port_and_catches_a_fault_below_the_old_floor():
    """The block's gradients pass; a 1% error in one tensor's gradient (far
    below the old floor of 5e-2 of the largest) fails the semantics bar."""
    nets, params, port_run, jax_grad = _block()
    port = port_grads(nets, port_run)
    jax_side = jax_grads(jax_grad, params)
    assert_grads_match(port, jax_side)
    (p32, p64) = port
    bad = {n: {k: v * (1.01 if k == "weight" else 1.0) for k, v in d.items()}
           for n, d in p64.items()}
    with pytest.raises(AssertionError, match="semantics"):
        assert_grads_match((p32, bad), jax_side)
