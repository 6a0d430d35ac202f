"""UNETR in the port against the JAX package (``models/unetr.py``).

* The ViT trunk at a small width (img 32, patch 16, hidden 48, MLP 96, 2
  layers, 4 heads; ``__graft_entry__``'s test ViT): ``SelfAttention``,
  ``TransformerBlock`` and ``ViT`` from converted weights, their forwards
  (with the ViT's hidden-state taps) and the gradients of the input and of
  every parameter; and the ViT with dropout 0.1 in "train" mode with JAX's
  five dropout sites' masks injected. No BatchNorm is crossed, so the bars
  are plain: forwards rtol 1e-5 / atol 1e-5 of the largest value,
  gradients rtol 1e-4 / atol 1e-5 of the module's largest gradient. flax's LayerNorm computes a single-pass variance in float32;
  the port's ``F.layer_norm`` a two-pass one: the gap is in those bars.
* The pyramid blocks (``ResConvBlock`` with and without its skip conv,
  ``PrUpBlock`` with its named transposed convs ``up{i}``, ``UpCatBlock``)
  and ``UNETREncoder``/``UNETRDecoder`` at hidden 48 (the encoder's ViT is
  the solver's 12 layers, 12 heads, MLP 3072 at that hidden), feature size
  8, 32^2, batch 4, code filters on: outputs and BatchNorm statistics in
  each mode ("eval" after a "train" pass), what every style hook of both
  modules sees (hooks that change their input, so a misplaced hook shows),
  and the gradients of both modules' parameters through
  ``test_torch_port_grad_bars.assert_grads_match`` (its float32 floor
  raised for a LeakyReLU kink crossing, ``KINK_FLOOR``). Forwards at
  test_torch_port_model's rtol 1e-4 / atol 5e-5 of the largest value,
  statistics rtol 1e-4 / atol 5e-5.
* The converter's repairs: named transposed convs flipped into (I, O)
  order by their module's kind, Dense kernels transposed, the position
  embedding kept, and a crop the ViT was not built for refused.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.models import unetr as ju
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.models import unetr as tu
from maxstyle_tpu_torch.models.layers import dropout_step
from tests.test_torch_port_grad_bars import assert_grads_match, jax_grads, port_grads

torch.set_num_threads(2)

SMALL_VIT = dict(img_size=32, patch_size=16, hidden_size=48, mlp_dim=96, num_layers=2,
                 num_heads=4)
FWD = dict(rtol=1e-4, atol=5e-5)


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def close(got, want, rtol, atol_frac, err_msg=""):
    """rtol, with an absolute floor of ``atol_frac`` of the largest value."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=atol_frac * max(float(np.abs(want).max()), 1e-30),
                               err_msg=err_msg)


def load(module, params, stats=None):
    module.load_state_dict(convert.flax_to_state_dict(to_np(params), to_np(stats or {})),
                           strict=True)
    return module


def grads_of(module):
    return {k: p.grad for k, p in module.named_parameters()}


def j_grads_of(grads):
    return convert.flax_to_state_dict(to_np(grads))


def assert_module_grads(got, want):
    """Each tensor at rtol 1e-4, atol 1e-5 of the module's largest gradient."""
    gmax = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-5 * gmax,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the trunk
# ---------------------------------------------------------------------------

def _trunk_case(kind):
    rng = np.random.RandomState({"attn": 0, "block": 1, "vit": 2}[kind])
    v = SMALL_VIT
    if kind == "vit":
        x = rng.rand(2, v["img_size"], v["img_size"], 1).astype(np.float32)
        jmod = ju.ViT(**v)
        tmod = tu.ViT(1, **v)
    else:
        x = rng.randn(2, 5, v["hidden_size"]).astype(np.float32)
        if kind == "attn":
            jmod = ju.SelfAttention(v["hidden_size"], v["num_heads"])
            tmod = tu.SelfAttention(v["hidden_size"], v["num_heads"])
        else:
            jmod = ju.TransformerBlock(v["hidden_size"], v["mlp_dim"], v["num_heads"])
            tmod = tu.TransformerBlock(v["hidden_size"], v["mlp_dim"], v["num_heads"])
    params = jmod.init(jax.random.key(3), jnp.asarray(x))["params"]
    # make the biases and LayerNorm affines non-trivial
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.randn(*a.shape), a.dtype), params)
    return jmod, tmod, params, x


def _j_apply(jmod, p, x, kind):
    if kind == "vit":
        return jmod.apply({"params": p}, x, train=False)
    return jmod.apply({"params": p}, x, deterministic=True)


@pytest.mark.parametrize("kind", ["attn", "block", "vit"])
def test_trunk_forward_taps_and_grads_match_jax(kind):
    jmod, tmod, params, x = _trunk_case(kind)
    load(tmod, params)
    rng = np.random.RandomState(9)
    jout = _j_apply(jmod, params, jnp.asarray(x), kind)
    jouts = [jout[0]] + list(jout[1]) if kind == "vit" else [jout]
    gs = [rng.randn(*o.shape).astype(np.float32) for o in jouts]

    def j_loss(p, xx):
        o = _j_apply(jmod, p, xx, kind)
        os_ = [o[0]] + list(o[1]) if kind == "vit" else [o]
        return sum(jnp.sum(a * g) for a, g in zip(os_, gs))

    jgp, jgx = jax.grad(j_loss, argnums=(0, 1))(params, jnp.asarray(x))
    tx = (nchw(x) if kind == "vit" else torch.from_numpy(x)).requires_grad_(True)
    tout = tmod(tx, "eval")
    touts = [tout[0]] + list(tout[1]) if kind == "vit" else [tout]
    assert len(touts) == len(jouts) == (1 + SMALL_VIT["num_layers"] if kind == "vit" else 1)
    for t, j in zip(touts, jouts):
        close(t, j, 1e-5, 1e-5)
    sum((t * torch.from_numpy(g)).sum() for t, g in zip(touts, gs)).backward()
    want = j_grads_of(jgp)
    got = grads_of(tmod)
    assert set(got) == set(want)
    assert_module_grads(got, want)
    jgx = np.asarray(jgx)
    close(tx.grad, jgx.transpose(0, 3, 1, 2) if kind == "vit" else jgx, 1e-4, 1e-5)


class _MaskRecorder:
    """flax interceptor recording each Dropout call's keep-mask by path."""

    def __init__(self):
        self.masks = {}

    def __call__(self, next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and not context.module.deterministic:
            self.masks["/".join(context.module.path)] = np.asarray(out) != 0
        return out


# JAX's dropout sites (flax auto-names) -> the port's ElementDropout names
def _port_site(path):
    if path == "Dropout_0":
        return "pos_drop"
    block, *rest = path.split("/")
    return f"{block}." + {"attn/Dropout_0": "attn.drop_weights", "attn/Dropout_1": "attn.drop_out",
                          "Dropout_0": "drop1", "Dropout_1": "drop2"}["/".join(rest)]


def test_vit_dropout_with_jax_masks_injected_matches_jax():
    """dropout 0.1 at the five sites, "train": the forward, the taps and the
    gradients with JAX's masks; "frozen" replays them, "eval" drops none."""
    v = dict(SMALL_VIT)
    x = np.random.RandomState(4).rand(2, 32, 32, 1).astype(np.float32)
    jmod = ju.ViT(**v, dropout_rate=0.1)
    params = jmod.init(jax.random.key(3), jnp.asarray(x))["params"]
    rec = _MaskRecorder()
    with fnn.intercept_methods(rec):  # the same key draws the same masks below
        jmod.apply({"params": params}, jnp.asarray(x), train=True,
                   rngs={"dropout": jax.random.key(11)})

    g = np.random.RandomState(5).randn(2, 4, v["hidden_size"]).astype(np.float32)

    def j_loss(p):
        final, hidden = jmod.apply({"params": p}, jnp.asarray(x), train=True,
                                   rngs={"dropout": jax.random.key(11)})
        return jnp.sum(final * g) + jnp.sum(hidden[0] ** 2), (final, hidden)

    (_, (jfinal, jhidden)), jgp = jax.value_and_grad(j_loss, has_aux=True)(params)
    assert len(rec.masks) == 1 + 4 * v["num_layers"]
    masks = {_port_site(k): torch.from_numpy(m) for k, m in rec.masks.items()}
    assert 0.8 < float(np.mean(np.concatenate([m.ravel() for m in rec.masks.values()]))) < 0.97

    tmod = load(tu.ViT(1, **v, dropout_rate=0.1), params)
    with dropout_step(tmod, None, masks):
        final, hidden = tmod(nchw(x), "train")
        ((final * torch.from_numpy(g)).sum() + (hidden[0] ** 2).sum()).backward()
        again, _ = tmod(nchw(x), "frozen")
    close(final, jfinal, 1e-5, 1e-5)
    close(hidden[1], jhidden[1], 1e-5, 1e-5)
    assert torch.equal(again, final.detach())
    assert_module_grads(grads_of(tmod), j_grads_of(jgp))
    plain, _ = jmod.apply({"params": params}, jnp.asarray(x), train=False)
    close(tmod(nchw(x), "eval")[0], plain, 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# the pyramid blocks, the encoder and the decoder
# ---------------------------------------------------------------------------

HW, N, F, HIDDEN = 32, 4, 8, 48


@pytest.mark.parametrize("kind", ["res_skip", "res_same", "prup", "upcat"])
def test_pyramid_blocks_match_jax_in_every_mode(kind):
    rng = np.random.RandomState(5)
    if kind == "res_skip":
        args = (rng.randn(N, 8, 8, 3),)
        jmod, tmod = ju.ResConvBlock(6), tu.ResConvBlock(3, 6)
    elif kind == "res_same":
        args = (rng.randn(N, 8, 8, 6),)
        jmod, tmod = ju.ResConvBlock(6), tu.ResConvBlock(6, 6)
    elif kind == "prup":
        args = (rng.randn(N, 2, 2, 10),)
        jmod, tmod = ju.PrUpBlock(6, num_layer=2), tu.PrUpBlock(10, 6, 2)
    else:
        args = (rng.randn(N, 4, 4, 10), rng.randn(N, 8, 8, 5))
        jmod, tmod = ju.UpCatBlock(6), tu.UpCatBlock(10, 5, 6)
    args = tuple(jnp.asarray(a, jnp.float32) for a in args)
    variables = jmod.init(jax.random.key(1), *args, train=False)
    load(tmod, variables["params"], variables["batch_stats"])
    stats = variables["batch_stats"]
    for mode in ("train", "frozen", "eval"):
        v = {"params": variables["params"], "batch_stats": stats}
        if mode == "eval":
            want = jmod.apply(v, *args, train=False)
        else:
            want, upd = jmod.apply(v, *args, train=True, mutable=["batch_stats"])
            new = upd["batch_stats"]
            stats = new if mode == "train" else stats
        got = tmod(*(nchw(a) for a in args), mode)
        close(got, np.asarray(want).transpose(0, 3, 1, 2), FWD["rtol"], 1e-5)
        sd = tmod.state_dict()
        for k, w in convert.flax_to_state_dict({}, to_np(stats)).items():
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), err_msg=f"{mode} {k}", **FWD)


@pytest.fixture(scope="module")
def enc_dec():
    """A small UNETR encoder and decoder (hidden 48) from JAX's init."""
    rng = np.random.RandomState(6)
    x = rng.rand(N, HW, HW, 1).astype(np.float32)
    jenc = ju.UNETREncoder(img_size=HW, feature_size=F, hidden_size=HIDDEN,
                           enable_code_filter=True)
    ev = jenc.init(jax.random.key(2), jnp.asarray(x), train=False)
    z = jenc.apply(ev, jnp.asarray(x), train=False, method=jenc.encode)
    jdec = ju.UNETRDecoder(out_ch=4, feature_size=F, hidden_size=HIDDEN)
    dv = jdec.init(jax.random.key(3), z, train=False)
    tenc = tu.UNETREncoder(1, img_size=HW, feature_size=F, hidden_size=HIDDEN,
                           enable_code_filter=True)
    tdec = tu.UNETRDecoder(4, F, HIDDEN)
    return jenc, to_np(ev), jdec, to_np(dv), tenc, tdec, x


def _hooks(seen, idxs):
    """Style hooks that record their input and change it."""
    def make(i):
        def f(v):
            seen[i] = v
            return v * 1.5 + 0.25
        return f
    return {i: make(i) for i in idxs}


@pytest.mark.parametrize("mode", ["train", "frozen", "eval"])
def test_encoder_decoder_match_jax_in_every_mode_with_every_hook(enc_dec, mode):
    jenc, ev, jdec, dv, tenc, tdec, x = enc_dec
    load(tenc, ev["params"], ev["batch_stats"])
    load(tdec, dv["params"], dv["batch_stats"])
    estats, dstats = ev["batch_stats"], dv["batch_stats"]
    if mode == "eval":  # after one "train" pass, so that eval normalizes with trained stats
        z = jenc.apply({**ev}, jnp.asarray(x), train=True, mutable=["batch_stats"],
                       method=jenc.encode)[1]["batch_stats"]
        estats = to_np(z)
        tenc.encode(nchw(x), "train")

    def j_run(seen_e, seen_d):
        venc = {"params": ev["params"], "batch_stats": estats}
        vdec = {"params": dv["params"], "batch_stats": dstats}
        train = mode != "eval"
        kw = dict(mutable=["batch_stats"]) if train else {}

        def enc_fn(mdl, xx):
            zz = mdl.encode(xx, train=train, style_fns=_hooks(seen_e, range(1, 6)))
            return zz, mdl.filter_code(zz, train=train)

        r = jenc.apply(venc, jnp.asarray(x), method=enc_fn, **kw)
        (z, zs), new_e = r if train else (r, {"batch_stats": estats})
        r = jdec.apply(vdec, zs, train=train, style_fns=_hooks(seen_d, range(6)), **kw)
        y, new_d = r if train else (r, {"batch_stats": dstats})
        if mode == "frozen":  # the statistics a frozen pass computes are dropped
            return z, zs, y, estats, dstats
        return z, zs, y, new_e["batch_stats"], new_d["batch_stats"]

    jseen_e, jseen_d = {}, {}
    jz, jzs, jy, new_e, new_d = j_run(jseen_e, jseen_d)
    tseen_e, tseen_d = {}, {}
    tz = tenc.encode(nchw(x), mode, style_fns=_hooks(tseen_e, range(1, 6)))
    tzs = tenc.filter_code(tz, mode)
    ty = tdec(tzs, mode, style_fns=_hooks(tseen_d, range(6)))
    assert sorted(tseen_e) == sorted(jseen_e) == [1, 2, 3, 4, 5]
    assert sorted(tseen_d) == sorted(jseen_d) == [0, 1, 2, 3, 4, 5]
    pairs = ([(tseen_e[i], jseen_e[i]) for i in range(1, 6)]
             + [(tseen_d[i], jseen_d[i]) for i in range(6)]
             + list(zip(tz, jz)) + list(zip(tzs, jzs)) + [(ty, jy)])
    for t, j in pairs:
        close(t, np.asarray(j).transpose(0, 3, 1, 2), FWD["rtol"], 1e-4)
    assert [tuple(z.shape[1:]) for z in tz] == [(F, 32, 32), (2 * F, 16, 16), (4 * F, 8, 8),
                                                (8 * F, 4, 4), (HIDDEN, 2, 2)]
    for module, stats in ((tenc, new_e), (tdec, new_d)):
        sd = module.state_dict()
        for k, w in convert.flax_to_state_dict({}, to_np(stats)).items():
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), err_msg=k, **FWD)


# One of the 16384 LeakyReLU inputs of decoder3's residual sum lies 1.75e-6
# from zero (float64), and the port's float32 rounds it across the kink (JAX's
# does not): the gradients behind it move by up to 3.8e-2 of a module's
# largest, in the port's float32 only (measured). So the float32 bars of this
# test take a floor of 5e-2 of the module's largest gradient; the float64
# semantics bar (1e-6) and the cosine hold as everywhere.
KINK_FLOOR = 5e-2


def test_encoder_decoder_gradients_match_jax(enc_dec):
    jenc, ev, jdec, dv, tenc, tdec, x = enc_dec
    g = np.random.RandomState(8).randn(N, HW, HW, 4).astype(np.float32)
    load(tenc, ev["params"], ev["batch_stats"])
    load(tdec, dv["params"], dv["batch_stats"])
    nets = torch.nn.ModuleDict({"image_encoder": tenc, "segmentation_decoder": tdec})

    def j_loss(p, dtype):
        s = {n: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v["batch_stats"])
             for n, v in (("e", ev), ("d", dv))}
        (z, zs), _ = jenc.apply({"params": p["image_encoder"], "batch_stats": s["e"]},
                                jnp.asarray(x, dtype), train=True, mutable=["batch_stats"])
        y, _ = jdec.apply({"params": p["segmentation_decoder"], "batch_stats": s["d"]}, zs,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(g, dtype))

    def port_run(n, dtype):
        _, zs = n["image_encoder"](nchw(x).to(dtype), "train")
        y = n["segmentation_decoder"](zs, "train")
        (y * nchw(g).to(dtype)).sum().backward()

    params = {"image_encoder": ev["params"], "segmentation_decoder": dv["params"]}
    assert_grads_match(port_grads(nets, port_run),
                       jax_grads(lambda p, dtype: jax.jit(jax.grad(
                                 lambda q: j_loss(q, dtype)))(p), params),
                       floor=KINK_FLOOR)


def test_converter_flips_named_transposed_convs_and_takes_dense_and_pos_embedding():
    rng = np.random.RandomState(3)
    up = tu.PrUpBlock(5, 3, 1)
    k0 = rng.randn(2, 2, 5, 3).astype(np.float32)
    k1 = rng.randn(2, 2, 3, 3).astype(np.float32)
    tree = {"up0": {"kernel": k0, "bias": np.zeros(3, np.float32)},
            "up1": {"kernel": k1, "bias": np.zeros(3, np.float32)}}
    sd = convert.flax_to_state_dict(tree)
    assert torch.equal(sd["up0.weight"], torch.from_numpy(
        np.ascontiguousarray(k0[::-1, ::-1].transpose(2, 3, 0, 1))))
    assert tuple(sd["up0.weight"].shape) == (5, 3, 2, 2)  # (I, O, kh, kw)
    for k in ("up0.weight", "up1.weight"):  # the shapes PrUpBlock's transposed convs take
        assert sd[k].shape == up.state_dict()[k].shape, k
    assert torch.equal(sd["up1.weight"], torch.from_numpy(
        np.ascontiguousarray(k1[::-1, ::-1].transpose(2, 3, 0, 1))))
    # the same kernel under a plain conv's name stays unflipped, (O, I)
    plain = convert.flax_to_state_dict({"conv": {"kernel": k1}})
    assert torch.equal(plain["conv.weight"], torch.from_numpy(
        np.ascontiguousarray(k1.transpose(3, 2, 0, 1))))
    dense = rng.randn(7, 4).astype(np.float32)
    pos = rng.randn(1, 4, 7).astype(np.float32)
    sd = convert.flax_to_state_dict({"linear1": {"kernel": dense}, "pos_embedding": pos})
    assert torch.equal(sd["linear1.weight"], torch.from_numpy(np.ascontiguousarray(dense.T)))
    assert torch.equal(sd["pos_embedding"], torch.from_numpy(pos))
    with pytest.raises(ValueError, match="2-D Dense or a 4-D conv"):
        convert.flax_to_state_dict({"x": {"kernel": np.zeros((2, 2, 2), np.float32)}})


def test_unetr_refuses_crops_it_was_not_built_for():
    with pytest.raises(ValueError, match="multiple of 16"):
        tu.UNETREncoder(1, img_size=40, feature_size=4, hidden_size=12,
                        mlp_dim=8, num_layers=10, num_heads=2)
    enc = tu.UNETREncoder(1, img_size=32, feature_size=4, hidden_size=12, mlp_dim=8,
                          num_layers=10, num_heads=2)
    for hw in ((48, 48), (32, 48)):
        with pytest.raises(ValueError, match="square crops"):
            enc.encode(torch.zeros(1, 1, *hw), "eval")
