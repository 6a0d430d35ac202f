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
head-major qkv, a head count that model_parallel does not divide
refused, and a model with dropout refused by ``tp_train_step`` under
data_parallel > 1.
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


def make_vit(weights=None):
    torch.manual_seed(0)
    vit = tu.ViT(1, **VIT)
    if weights is not None:
        vit.load_state_dict(torch.load(weights), strict=True)
    return vit


def inputs():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(4, 1, 32, 32).astype(np.float32))
    target = torch.from_numpy(rng.rand(4, 4, 48).astype(np.float32))
    return x, target


def mse(model, batch):
    final, _ = model(batch["x"], "eval")
    return torch.mean((final - batch["y"]) ** 2)


def _worker(rank, world, mp, store, out_dir, weights):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        grid = tp.make_grid(mp)
        vit = tp.parallelize_vit(make_vit(weights), grid, VIT["num_heads"])
        x, y = inputs()
        n = x.shape[0] // grid.data_parallel
        rows = slice(grid.data_rank * n, (grid.data_rank + 1) * n)
        with torch.no_grad():
            final, hidden = vit(x[rows], "eval")
        opt = torch.optim.AdamW(vit.parameters(), lr=LR, weight_decay=0.01)
        step = tp.tp_train_step(vit, opt, mse, grid)
        loss = step({"x": x[rows], "y": y[rows]})
        torch.save({"final": final, "last_hidden": hidden[-1], "loss": loss,
                    "state": vit.state_dict(), "rows": (rows.start, rows.stop),
                    "grads": {n: p.grad for n, p in vit.named_parameters()},
                    "model_rank": grid.model_rank},
                   os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(tmp_path, world, mp, weights):
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, mp, str(tmp_path / "store"),
                                               str(tmp_path), weights))
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


def port_reference(weights, x, y):
    """The port's single-process ViT on the same weights: forward, loss,
    gradients and one torch.optim.AdamW step."""
    ref = make_vit(weights)
    with torch.no_grad():
        final, hidden = ref(x, "eval")
    opt = torch.optim.AdamW(ref.parameters(), lr=LR, eps=ADAM_EPS, weight_decay=0.01)
    loss = mse(ref, {"x": x, "y": y})
    loss.backward()
    grads = {n: p.grad.clone() for n, p in ref.named_parameters()}
    opt.step()
    return {"final": final, "last_hidden": hidden[-1], "loss": float(loss.detach()),
            "grads": grads, "state": ref.state_dict()}


def assert_world_matches(results, ref, world, mp, label):
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
                                       atol=1e-6 * float(g_ref.abs().max()),
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


@pytest.mark.parametrize("dp,rate,refused", [(2, 0.1, True), (2, 0.0, False), (1, 0.1, False)])
def test_dropout_is_refused_under_data_parallel(dp, rate, refused):
    vit = tu.ViT(1, **VIT, dropout_rate=rate)
    grid = tp.Grid(world=2 * dp, model_parallel=2, rank=0, data_group=None, model_group=None)
    opt = torch.optim.AdamW(vit.parameters(), lr=LR)
    if refused:
        with pytest.raises(ValueError, match="dropout under data_parallel > 1"):
            tp.tp_train_step(vit, opt, mse, grid)
    else:
        assert callable(tp.tp_train_step(vit, opt, mse, grid))
