"""Dropout within a training step, against the JAX step.

The JAX step splits one "dropout" key a step and hands the same ``rngs`` to
every pass, so each FixableDropout applies one mask to the standard pass,
the MaxStyle decodes and the hard-example pass. The port draws one seed a
step from the step's generator, and each layer derives its mask from that
seed and its name. Held here, at a small width (FCN_16, 40^2 pads, 32^2
crops) with ``encoder_dropout = decoder_dropout = 0.5``:

* every pass of one step sees the same mask in each layer (read off each
  layer's output: a dropped channel is zero where its input is not);
* two steps draw different masks, and the same generator seed the same;
* without a dropout rate the step draws no seed: the generator ends in the
  state it reaches with the draw stubbed out;
* one step matches JAX's step with JAX's masks injected through
  ``overrides["dropout_masks"]``: torch's generator cannot give JAX's
  bernoulli bits, so the masks are read off the outputs of JAX's
  FixableDropout layers (``capture_intermediates``) under the step's
  dropout key. With n_iter=0 (the styled decode and the hard-example pass,
  no inner Adam step) every tolerance of
  ``tests/test_torch_port_train_step.py`` holds. With n_iter=5 the losses,
  the weight bound and the BatchNorm statistics hold at those tolerances,
  but not the update cosine (0.77 for the encoder, measured): the first
  inner Adam step moves each style element by lr*sign(g), and at dropout
  0.5 one of the 272 style elements here has a gradient at 6.4e-5 of its
  tensor's largest, whose sign differs; that one element moves by 2*lr
  (0.2) and the hard-example gradients follow it. Every other element
  agreed to 7.2e-7 after the first inner step (measured at n_iter=1). The
  second witness: the first inner step's gradients, JAX's and the port's
  in float32, both lie within float32 noise (0.1-5% of each tensor's
  largest element, measured) of the port's float64 gradients, and the
  elements whose sign differs lie below that noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maxstyle_tpu import prng
from maxstyle_tpu.models.layers import FixableDropout as JFixableDropout
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch import solver as tsolver
from maxstyle_tpu_torch import train_step as T
from maxstyle_tpu_torch.models.layers import FixableDropout, dropout_step
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from tests.test_torch_port_train_step import (CROP, HALF, INDEXES, assert_port_step_matches,
                                              config, jax_step, jax_styles, nchw, port_styles)

torch.set_num_threads(2)

RATE = 0.5
STEP_KEY = 3


def dropout_config(n_iter=5, rate=RATE):
    cfg = config(n_iter)
    return dataclasses.replace(cfg, learning=dataclasses.replace(
        cfg.learning, encoder_dropout=rate, decoder_dropout=rate))


def port_solver(cfg):
    return TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")


def batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"image": torch.rand((2 * HALF, CROP, CROP, 1), generator=g),
            "label": torch.randint(0, 4, (2 * HALF, CROP, CROP), generator=g)}


def run_steps(cfg, n_steps, gen_seed=5, weight_seed=1):
    """Run ``n_steps`` steps; return, for each step, {layer name: [(keep,
    live) of each pass]}, both boolean [N,C]: whether a channel's output is
    nonzero somewhere, and whether its input was."""
    ts = port_solver(cfg)
    state = ts.init_state(seed=weight_seed)
    seen = []

    def hook(module, inputs, output):
        x = inputs[0]
        live = (x != 0).flatten(2).any(-1)
        keep = (output != 0).flatten(2).any(-1)
        seen[-1].setdefault(module.name, []).append((keep, live))

    layers = {name: m for name, m in state.modules.named_modules()
              if isinstance(m, FixableDropout)}
    handles = [m.register_forward_hook(hook) for m in layers.values()]
    step = T.make_train_step(ts)
    gen = torch.Generator().manual_seed(gen_seed)
    try:
        for k in range(n_steps):
            seen.append({})
            state, _ = step(state, batch(k), gen)
    finally:
        for h in handles:
            h.remove()
    return seen, list(layers)


def step_mask(passes):
    """The one mask every pass of a step showed in a layer (asserts they
    agree wherever both inputs were live)."""
    keep0, live0 = passes[0]
    for keep, live in passes[1:]:
        both = live & live0
        assert torch.equal(keep[both], keep0[both])
    return keep0


@pytest.fixture(scope="module")
def two_steps():
    return run_steps(dropout_config(n_iter=1), 2)


def test_every_pass_of_a_step_sees_one_mask(two_steps):
    seen, names = two_steps
    assert len(names) == 4 + 4 + 4   # down1-4, and up1-4 of both decoders
    assert all(n for n in names) and len(set(names)) == len(names)
    for name in names:
        passes = seen[0][name]
        # standard, hard example, and (encoder, image decoder) the MaxStyle passes
        assert len(passes) >= 2, name
        keep = step_mask(passes)
        assert 0.0 < float(keep.float().mean()) < 1.0, name


def test_two_steps_draw_different_masks(two_steps):
    seen, names = two_steps
    for name in names:
        assert not torch.equal(step_mask(seen[0][name]), step_mask(seen[1][name])), name


def test_same_generator_seed_gives_same_masks(two_steps):
    seen, names = two_steps
    again, _ = run_steps(dropout_config(n_iter=1), 1)
    other, _ = run_steps(dropout_config(n_iter=1), 1, gen_seed=6)
    for name in names:
        assert torch.equal(step_mask(seen[0][name]), step_mask(again[0][name])), name
    assert any(not torch.equal(step_mask(seen[0][n]), step_mask(other[0][n])) for n in names)


@pytest.mark.parametrize("rate", [None, RATE])
def test_seed_is_drawn_only_with_a_dropout_rate(monkeypatch, rate):
    """The generator's state after a step against its state after the same
    step with the seed draw stubbed out: equal without a dropout rate (the
    headline's stream is unchanged), different with one."""
    cfg = dropout_config(n_iter=1, rate=rate)

    def state_after(stub):
        if stub:
            monkeypatch.setattr(T, "draw_dropout_seed", lambda g: 12345)
        ts = port_solver(cfg)
        gen = torch.Generator().manual_seed(9)
        T.make_train_step(ts)(ts.init_state(seed=1), batch(), gen)
        monkeypatch.undo()
        return gen.get_state()

    real, stubbed = state_after(False), state_after(True)
    assert torch.equal(real, stubbed) == (rate is None)


def test_mask_outside_a_step_raises_and_eval_is_identity():
    layer = FixableDropout(RATE)
    x = torch.ones((2, 3, 4, 4))
    assert layer(x, "eval") is x
    with pytest.raises(RuntimeError):
        layer(x, "frozen")
    nets = torch.nn.ModuleList([layer])
    with dropout_step(nets, 7):
        a = layer(x, "train")
        assert torch.equal(a, layer(x, "frozen"))
    with dropout_step(nets, 7):
        assert torch.equal(a, layer(x, "train"))


def jax_masks(r):
    """{port layer name: boolean keep-mask [N,C,1,1]} of JAX's step with key
    ``STEP_KEY``: each module applied as the step applies it, with the
    step's dropout key, capturing its FixableDropout outputs."""
    cfg = r["cfg"]
    js = JSolver(cfg, maxstyle_backend="pallas")
    params = jax.tree_util.tree_map(jnp.asarray, r["params0"])
    stats = jax.tree_util.tree_map(jnp.asarray, r["stats0"])
    kd = prng.split_dict(jax.random.key(STEP_KEY), ("noise", "maxstyle", "dropout",
                                                    "branches"))["dropout"]
    image = jnp.asarray(r["image"])
    (z_i, z_s), _ = js.encode_image(params, stats, image, mode="frozen",
                                    rngs={"dropout": kd})
    enc = js.modules["image_encoder"]
    runs = {"image_encoder": (image, enc.encode, "general_encoder."),
            "segmentation_decoder": (z_s, None, ""), "image_decoder": (z_i, None, "")}
    masks = {}
    for module, (arg, method, prefix) in runs.items():
        _, upd = js.modules[module].apply(
            {"params": params[module], "batch_stats": stats[module]}, arg, train=True,
            method=method, rngs={"dropout": kd}, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, JFixableDropout))
        tree = upd["intermediates"]
        for path, out in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [p.key for p in path if hasattr(p, "key")]
            block = [k for k in keys if k.startswith(("down", "up"))][0]
            if prefix:
                block = prefix + block
            keep = np.asarray(out != 0).any(axis=(1, 2))          # [N, C]
            masks[f"{module}.{block}.dropout"] = torch.from_numpy(keep)[:, :, None, None]
    return masks


def injected_masks(r):
    masks = jax_masks(r)
    ts = port_solver(r["cfg"])
    names = {name for name, m in ts.build_modules().named_modules()
             if isinstance(m, FixableDropout)}
    assert set(masks) == names
    for name, keep in masks.items():
        assert 0.0 < float(keep.float().mean()) < 1.0, name
    return {"dropout_masks": masks}


def test_one_step_with_dropout_matches_jax():
    r = jax_step(dropout_config(n_iter=0), STEP_KEY)
    assert_port_step_matches(r, injected_masks(r))


@pytest.fixture(scope="module")
def maxstyle_run():
    return jax_step(dropout_config(n_iter=5), STEP_KEY)


def test_maxstyle_step_with_dropout_matches_jax_losses(maxstyle_run):
    r = maxstyle_run
    assert_port_step_matches(r, injected_masks(r), update_cosine=False)


def jax_inner_grads(r, monkeypatch):
    """JAX's gradients of the first inner Adam step with respect to each
    style tensor, in the port's layout: ``generate_max_style_image`` at
    n_iter=1 on the frozen code of the noisy input, under the step's dropout
    key, with the inner optimizer wrapped to report what it is given."""
    cfg = r["cfg"]
    js = JSolver(cfg, maxstyle_backend="pallas")
    params = jax.tree_util.tree_map(jnp.asarray, r["params0"])
    stats = jax.tree_util.tree_map(jnp.asarray, r["stats0"])
    keys = prng.split_dict(jax.random.key(STEP_KEY), ("noise", "maxstyle", "dropout",
                                                      "branches"))
    rngs = {"dropout": keys["dropout"]}
    seen = []
    adam = optax.adam

    def reporting_adam(lr):
        tx = adam(lr)

        def update(grads, state, p=None):
            jax.debug.callback(lambda g: seen.append(jax.tree_util.tree_map(np.asarray, g)),
                               grads)
            return tx.update(grads, state, p)
        return optax.GradientTransformation(tx.init, update)

    monkeypatch.setattr(optax, "adam", reporting_adam)
    (z_i, _), _ = js.encode_image(params, stats, jnp.asarray(r["image_n"]), mode="frozen",
                                  rngs=rngs)
    js.generate_max_style_image(params, stats, z_i, reference_segmentation=jnp.asarray(r["label"]),
                                ms_cfg=dataclasses.replace(cfg.max_style, n_iter=1),
                                rng=keys["maxstyle"], rngs=rngs,
                                style_init=jax_styles(r["values"]))
    monkeypatch.undo()
    jax.effects_barrier()
    (g,) = seen
    return [torch.from_numpy(np.array(a if a.shape[-1] == 1 else a.transpose(0, 3, 1, 2)))
        for idx in INDEXES for a in (g[idx].lmda, g[idx].gamma_noise, g[idx].beta_noise)]


def port_inner_grads(r, masks, dtype, monkeypatch):
    """The port's gradients of the same first inner step, computed in
    ``dtype`` (weights, code and style tensors cast), with JAX's masks."""
    ts = port_solver(dropout_config(n_iter=1))
    nets = ts.init_state(state_dicts=convert.convert_train_state(
        r["params0"], r["stats0"])).modules.to(dtype)
    sp, st = port_styles(r["values"])
    sp = {i: tms_cast(p, dtype) for i, p in sp.items()}
    st = {i: tms_cast(s, dtype) for i, s in st.items()}
    seen = []
    adam = tsolver._inner_adam

    def reporting_adam(params, grads, *rest, **kw):
        seen.append([g.detach().double().clone() for g in grads])
        return adam(params, grads, *rest, **kw)

    monkeypatch.setattr(tsolver, "_inner_adam", reporting_adam)
    with dropout_step(nets, None, masks):
        z_i, _ = ts.encode_image(nets, nchw(r["image_n"]).to(dtype), mode="frozen")
        ts.generate_max_style_image(nets, z_i.detach(),
                                    reference_segmentation=torch.from_numpy(r["label"]).long(),
                                    ms_cfg=ts.config.max_style, generator=torch.Generator(),
                                    style_init=(sp, st))
    monkeypatch.undo()
    (g,) = seen
    return g


def tms_cast(obj, dtype):
    """A MaxStyle params or state dataclass with its float tensors cast."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dtype) if getattr(obj, f.name).is_floating_point()
        else getattr(obj, f.name) for f in dataclasses.fields(obj)})


def test_inner_style_gradients_with_dropout_agree_within_float32_noise(maxstyle_run,
                                                                         monkeypatch):
    """The second witness for the n_iter=5 test above: its update cosine
    fails on one style element whose first inner Adam step goes the other
    way in the port and in JAX. Here the gradients of that first step, JAX's
    and the port's in float32, are held against the port's own in float64.
    A mask or mode fault would put one side far from it; instead both are
    within float32 noise of it (under 0.1 of each tensor's largest element,
    cosine above 0.999), and every element whose sign differs between the
    two sides has a float64 gradient below that noise, so float32 cannot fix
    its sign on either side."""
    r = maxstyle_run
    masks = injected_masks(r)["dropout_masks"]
    jx = jax_inner_grads(r, monkeypatch)
    p32 = port_inner_grads(r, masks, torch.float32, monkeypatch)
    p64 = port_inner_grads(r, masks, torch.float64, monkeypatch)
    flipped = 0
    for k, (a, b, ref) in enumerate(zip(jx, p32, p64)):
        a, ref = a.double().reshape(ref.shape), ref
        scale = float(ref.abs().max())
        err_j, err_p = (float((x - ref).abs().max()) / scale for x in (a, b))
        noise = max(err_j, err_p)
        assert noise < 0.1, f"tensor {k}: float32 vs float64, JAX {err_j:.3e}, port {err_p:.3e}"
        for x in (a, b):
            assert float(x.flatten() @ ref.flatten() / (x.norm() * ref.norm())) > 0.999, k
        flips = torch.sign(a) != torch.sign(b)
        flipped += int(flips.sum())
        assert bool((ref[flips].abs() <= noise * scale).all()), k
    assert flipped >= 1
