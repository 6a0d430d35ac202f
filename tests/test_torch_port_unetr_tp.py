"""Megatron tensor parallelism over UNETR's ViT (``parallel/tp.py``) in CPU
processes over gloo, against the single-process ViT of the port and of the
JAX package.

The ViT is tests/test_sharding.py's (img 32, patch 16, hidden 48, MLP 96, 2
layers, 4 heads), with the JAX package's seed-0 init converted by
``convert.py`` and loaded in every process. Worlds of 2 (data 1 x model 2)
and 4 (data 2 x model 2) processes, started with ``spawn`` and a
``file://`` store under the test's directory, each:

* run the forward on their data shard of the batch [4, 32, 32, 1] in
  "eval" mode: the final tokens and the last hidden state at
  tests/test_sharding.py's forward bar (rtol 2e-5 / atol 1e-5);
* take one AdamW(1e-3) step of ``tp_train_step`` on the MSE of the final
  tokens against a seeded target: the loss at rtol 5e-5 (the solver-level
  bar there), the gradients averaged over 'data' and every updated
  parameter, shards put back together, at rtol 2e-5 / atol 1e-6 (its
  update bar; for the gradients 1e-6 of the largest). Adam's first step
  maps g to lr * g / (|g| + eps), whose slope eps / (|g| + eps)^2 reaches
  1 / (4 eps) where |g| is near eps = 1e-8, so a rounding-size gradient
  gap on an element that small becomes a step gap of up to lr / (4 eps)
  times it. So each parameter's atol adds that slope times lr times the
  element's measured gradient gap, the first-order image of the gradient
  bar through the optimizer.

Each world is held at those bars against two single-process references on
the same weights and batch: the port's ViT with torch.optim.AdamW, and the
JAX package's ViT with optax.adamw (the counterpart of
``shard_tp_train_step``'s single-device result), converted to the port's
names.

The processes are joined with a timeout (a hung collective fails the test
instead of eating the suite's time). Without processes: the splits of
every ViT parameter, whole heads with their q, k and v on each rank of the
head-major qkv, and a head count that model_parallel does not divide
refused. With dropout 0.1 under data_parallel 2 (data 2 x model 2), the
world's "train"-mode step takes the single process's masks (drawn by it,
its batch rows on each data rank and each model rank's shard of the split
sites' masks, injected through ``layers.dropout_step`` at the global batch
shape) and holds the single process's step at the bars above, the
gradients' at 5e-6 of each parameter's largest: with dropout the gaps
reach 2.6e-6 of it (measured, block1.norm2.weight; 1.3e-6 on the patch
embedding), the float32 rounding of the masked sums over two ranks.
"""

import os

import numpy as np
import pytest
import torch

from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.models import unetr as tu
from maxstyle_tpu_torch.parallel import tp

VIT = dict(img_size=32, patch_size=16, hidden_size=48, mlp_dim=96, num_layers=2, num_heads=4)
JOIN_TIMEOUT = 150  # seconds; a world takes ~10 s
LR = 1e-3
ADAM_EPS = 1e-8  # torch.optim.AdamW's default


def make_vit(weights=None, rate=0.0):
    torch.manual_seed(0)
    vit = tu.ViT(1, **VIT, dropout_rate=rate)
    if weights is not None:
        vit.load_state_dict(torch.load(weights), strict=True)
    return vit


def inputs():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(4, 1, 32, 32).astype(np.float32))
    target = torch.from_numpy(rng.rand(4, 4, 48).astype(np.float32))
    return x, target


def mse(model, batch, mode="eval"):
    final, _ = model(batch["x"], mode)
    return torch.mean((final - batch["y"]) ** 2)


def mse_train(model, batch):
    return mse(model, batch, "train")


# the dropout sites whose masks are split over 'model': the attention weights
# [N, heads, T, T] by head, the GELU output [N, T, mlp] by feature
SPLIT_MASKS = {"attn.drop_weights": 1, "drop1": 2}


def mask_shard(masks, model_rank, mp):
    """A model rank's masks: the split sites' shard, the others whole."""
    out = {}
    for name, m in masks.items():
        dim = next((d for suffix, d in SPLIT_MASKS.items() if name.endswith(suffix)), None)
        out[name] = m if dim is None else m.chunk(mp, dim)[model_rank]
    return out


def _worker(rank, world, mp, store, out_dir, weights, rate=0.0, masks=None):
    import torch.distributed as dist

    from maxstyle_tpu_torch.models.layers import dropout_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        grid = tp.make_grid(mp)
        vit = tp.parallelize_vit(make_vit(weights, rate), grid, VIT["num_heads"])
        x, y = inputs()
        n = x.shape[0] // grid.data_parallel
        rows = slice(grid.data_rank * n, (grid.data_rank + 1) * n)
        with torch.no_grad():
            final, hidden = vit(x[rows], "eval")
        opt = torch.optim.AdamW(vit.parameters(), lr=LR, weight_decay=0.01)
        if masks is None:
            loss = tp.tp_train_step(vit, opt, mse, grid)({"x": x[rows], "y": y[rows]})
        else:
            step = tp.tp_train_step(vit, opt, mse_train, grid)
            given = mask_shard(torch.load(masks), grid.model_rank, mp)
            with dropout_step(vit, None, given):
                loss = step({"x": x[rows], "y": y[rows]})
        torch.save({"final": final, "last_hidden": hidden[-1], "loss": loss,
                    "state": vit.state_dict(), "rows": (rows.start, rows.stop),
                    "grads": {n: p.grad for n, p in vit.named_parameters()},
                    "model_rank": grid.model_rank},
                   os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(tmp_path, world, mp, weights, rate=0.0, masks=None):
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, mp, str(tmp_path / "store"),
                                               str(tmp_path), weights, rate, masks))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} of {world} processes still ran after {JOIN_TIMEOUT} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


def jax_reference(x, y):
    """The JAX package's ViT from seed 0: its weights, forward, loss,
    gradients and one optax.adamw step, as the port's state dicts."""
    import jax
    import jax.numpy as jnp
    import optax

    from maxstyle_tpu.models import unetr as ju

    jmod = ju.ViT(**VIT)
    xj = jnp.asarray(x.numpy().transpose(0, 2, 3, 1))
    params = jmod.init(jax.random.key(0), xj, train=False)["params"]

    def loss_fn(p):
        final, _ = jmod.apply({"params": p}, xj, train=False)
        return jnp.mean((final - jnp.asarray(y.numpy())) ** 2)

    final, hidden = jmod.apply({"params": params}, xj, train=False)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = optax.adamw(LR, eps=ADAM_EPS, weight_decay=0.01)
    updates, _ = tx.update(grads, tx.init(params), params)

    def port(tree):
        return convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, tree))

    return {"weights": port(params), "final": torch.from_numpy(np.array(final)),
            "last_hidden": torch.from_numpy(np.array(hidden[-1])), "loss": float(loss),
            "grads": port(grads), "state": port(optax.apply_updates(params, updates))}


def port_reference(weights, x, y, rate=0.0, seed=None):
    """The port's single-process ViT on the same weights: forward, loss,
    gradients and one torch.optim.AdamW step; with ``rate`` the loss is a
    "train"-mode forward with dropout from ``seed``, whose masks come back
    as "masks"."""
    from maxstyle_tpu_torch.models.layers import ElementDropout, dropout_step

    ref = make_vit(weights, rate)
    with torch.no_grad():
        final, hidden = ref(x, "eval")
    opt = torch.optim.AdamW(ref.parameters(), lr=LR, eps=ADAM_EPS, weight_decay=0.01)
    masks = {}
    if rate:
        with dropout_step(ref, seed):
            loss = mse_train(ref, {"x": x, "y": y})
            for name, m in ref.named_modules():
                if isinstance(m, ElementDropout):
                    (masks[name],) = m._masks.values()
    else:
        loss = mse(ref, {"x": x, "y": y})
    loss.backward()
    grads = {n: p.grad.clone() for n, p in ref.named_parameters()}
    opt.step()
    return {"final": final, "last_hidden": hidden[-1], "loss": float(loss.detach()),
            "grads": grads, "state": ref.state_dict(), "masks": masks}


def assert_world_matches(results, ref, world, mp, label, grad_atol=1e-6):
    """Every rank's forward and loss, and every reassembled gradient and
    updated parameter, against ``ref`` at the bars of the module docstring."""
    for r in results:
        rows = slice(*r["rows"])
        np.testing.assert_allclose(r["final"].numpy(), ref["final"][rows].numpy(), rtol=2e-5,
                                   atol=1e-5, err_msg=label)
        np.testing.assert_allclose(r["last_hidden"].numpy(), ref["last_hidden"][rows].numpy(),
                                   rtol=2e-5, atol=1e-5, err_msg=label)
        np.testing.assert_allclose(float(r["loss"].detach()), ref["loss"], rtol=5e-5,
                                   err_msg=label)
    splits = tp.vit_tp_splits(ref["state"])
    # a block's split tensors: the qkv, out_proj, linear1 and linear2 weights and
    # linear1's bias (qkv has no bias; the row-parallel biases stay whole)
    assert sum(d is not None for d in splits.values()) == 5 * VIT["num_layers"]
    for name, want in ref["state"].items():
        dim = splits[name]
        for d0 in range(world // mp):  # every data rank holds the same update
            shards = sorted((r for r in results if r["rows"][0] == d0 * (4 // (world // mp))),
                            key=lambda r: r["model_rank"])

            def whole(key):
                return (shards[0][key][name] if dim is None
                        else torch.cat([s[key][name] for s in shards], dim))

            g, g_ref = whole("grads"), ref["grads"][name]
            np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=2e-5,
                                       atol=grad_atol * float(g_ref.abs().max()),
                                       err_msg=f"{label}: {name}")
            slope = ADAM_EPS / (g_ref.abs() + ADAM_EPS) ** 2
            atol = 1e-6 + LR * slope * (g - g_ref).abs()
            got = whole("state")
            assert bool(((got - want).abs() <= atol + 2e-5 * want.abs()).all()), (
                label, name, float((got - want).abs().max()))
            if dim is None:
                for s in shards[1:]:
                    assert torch.equal(s["state"][name], shards[0]["state"][name]), name


@pytest.mark.parametrize("world,mp", [(2, 2), (4, 2)])
def test_tp_forward_and_adamw_step_match_one_process(tmp_path, world, mp):
    x, y = inputs()
    jax_ref = jax_reference(x, y)
    weights = str(tmp_path / "vit.pt")
    torch.save(jax_ref["weights"], weights)
    results = run_world(tmp_path, world, mp, weights)
    assert_world_matches(results, port_reference(weights, x, y), world, mp, "port")
    assert_world_matches(results, jax_ref, world, mp, "jax")


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_every_rank_holds_whole_heads(mp):
    vit = make_vit()
    heads, d, hidden = VIT["num_heads"], VIT["hidden_size"] // VIT["num_heads"], \
        VIT["hidden_size"]
    full = vit.state_dict()
    per_head = full["block0.attn.qkv.weight"].reshape(heads, 3, d, hidden)
    for rank in range(mp):
        shard = tp.shard_vit_state(full, rank, mp, heads)
        hl = heads // mp
        mine = per_head[rank * hl:(rank + 1) * hl]
        assert torch.equal(shard["block0.attn.qkv.weight"], mine.reshape(hl * 3 * d, hidden))
        # out_proj's input columns are the same heads' (head, dim) outputs
        cols = full["block0.attn.out_proj.weight"][:, rank * hl * d:(rank + 1) * hl * d]
        assert torch.equal(shard["block0.attn.out_proj.weight"], cols)
        assert torch.equal(shard["block0.attn.out_proj.bias"], full["block0.attn.out_proj.bias"])
        assert torch.equal(shard["norm.weight"], full["norm.weight"])


def test_a_head_count_that_model_parallel_does_not_divide_is_refused():
    with pytest.raises(ValueError, match="part of a head"):
        tp.shard_vit_state(make_vit().state_dict(), 0, 3, VIT["num_heads"])


@pytest.mark.parametrize("dp,rate,run", [(2, 0.1, True), (2, 0.0, False), (1, 0.1, False)])
def test_dropout_is_refused_under_data_parallel(tmp_path, dp, rate, run):
    """No data_parallel and dropout rate is refused any more; with dropout
    under data_parallel 2 a world of 4 equals the single process (module
    docstring)."""
    vit = tu.ViT(1, **VIT, dropout_rate=rate)
    grid = tp.Grid(world=2 * dp, model_parallel=2, rank=0, data_group=None, model_group=None)
    opt = torch.optim.AdamW(vit.parameters(), lr=LR)
    assert callable(tp.tp_train_step(vit, opt, mse, grid))
    if not run:
        return
    x, y = inputs()
    weights = str(tmp_path / "vit.pt")
    torch.save(make_vit().state_dict(), weights)
    ref = port_reference(weights, x, y, rate=rate, seed=7)
    assert len(ref["masks"]) == 1 + 4 * VIT["num_layers"]
    masks = str(tmp_path / "masks.pt")
    torch.save(ref["masks"], masks)
    results = run_world(tmp_path, 2 * dp, 2, weights, rate, masks)
    assert_world_matches(results, ref, 2 * dp, 2, "dropout", grad_atol=5e-6)
