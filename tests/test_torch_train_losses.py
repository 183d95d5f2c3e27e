"""Port parity of the losses, the learning-rate schedule and the optimizer:
``sgg_torch.train.{losses,state}`` against ``sgg_tpu.train.{losses,state}``
on the CPU in f32. Losses within 1e-6; updated parameters within 1e-6
relative, per tensor, to its largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.config import Config as JConfig
from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.train import losses as jlosses
from sgg_tpu.train.assign import all_pairs
from sgg_tpu.train.state import create_train_state
from sgg_tpu.train.state import multistep_lr as jmultistep_lr
from sgg_torch.config import Config
from sgg_torch.convert import variables_from_jax
from sgg_torch.models.relhead import RelModelIMP
from sgg_torch.train import losses
from sgg_torch.train.state import Optimizer, multistep_lr, param_label
from test_torch_models import random_variables

B, E, R, N, C = 3, 7, 5, 6, 9


def _edges(case, seed=0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, E, R) * 2).astype(np.float32)
    labels = rng.randint(0, R, (B, E)).astype(np.int32)
    labels[:, :2] = [0, 3]  # both kinds in every image
    mask = rng.rand(B, E) < 0.8
    mask[:, :2] = True
    if case == "no_fg":
        labels[:] = 0
    elif case == "no_bg":
        labels[labels == 0] = 1
    elif case == "all_masked":
        mask[:] = False
    return logits, labels, mask


@pytest.mark.parametrize("case", ["mixed", "no_fg", "no_bg", "all_masked"])
@pytest.mark.parametrize("loss_type", ["baseline", "dnorm", "dnorm-fgbg"])
def test_edge_losses_match_jax(loss_type, case):
    logits, labels, mask = _edges(case)
    weights = (1.0, 1.0, 0.7) if loss_type == "baseline" else (0.6, 1.3, 0.7)
    want = jlosses.edge_losses(jnp.asarray(logits), jnp.asarray(labels),
                               jnp.asarray(mask), loss_type, weights)
    got = losses.edge_losses(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             torch.from_numpy(mask), loss_type, weights)
    assert set(got) == set(want) == {"rel_loss"}
    assert abs(float(got["rel_loss"]) - float(want["rel_loss"])) <= 1e-6


@pytest.mark.parametrize("all_masked", [False, True])
def test_node_losses_match_jax(all_masked):
    rng = np.random.RandomState(1)
    logits = (rng.randn(B, N, C) * 2).astype(np.float32)
    labels = rng.randint(0, C, (B, N)).astype(np.int32)
    mask = np.zeros((B, N), bool) if all_masked else rng.rand(B, N) < 0.7
    want = jlosses.node_losses(jnp.asarray(logits), jnp.asarray(labels),
                               jnp.asarray(mask))["obj_loss"]
    got = losses.node_losses(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             torch.from_numpy(mask))["obj_loss"]
    assert abs(float(got) - float(want)) <= 1e-6


def test_multistep_lr_matches_optax_schedule():
    want = jmultistep_lr(0.03, (3, 7), 0.1, steps_per_epoch=4)
    got = multistep_lr(0.03, (3, 7), 0.1, steps_per_epoch=4)
    counts = range(45)  # boundaries at 16 and 32 updates
    assert {round(got(c), 12) for c in counts} == {0.03, 0.003, 0.0003}
    for c in counts:
        assert abs(got(c) - float(want(c))) <= 1e-7 * got(c), c


def _model():
    jm = JModel(num_classes=C, num_predicates=R, hidden_dim=16, obj_dim=32,
                use_bias=True, dtype=jnp.float32)
    pairs, pm = all_pairs(jnp.ones((1, 3), bool))
    v = random_variables(jm, (jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 3, 4)),
                              jnp.ones((1, 3), jnp.int32), pairs, pm), seed=4)
    tm = RelModelIMP(num_classes=C, num_predicates=R, hidden_dim=16,
                     obj_dim=32, use_bias=True)
    tm.load_state_dict(variables_from_jax(v), strict=True)
    return v, tm


def test_param_groups():
    _, tm = _model()
    labels = {n: param_label(n) for n, _ in tm.named_parameters()}
    assert set(labels.values()) == {"frozen", "fc", "main"}
    for n, label in labels.items():
        assert label == ("frozen" if n.startswith("trunk.") else
                         "fc" if n.startswith("roi_fmap") else "main"), n


# three updates with one LR boundary (steps=(0,), 2 updates an epoch); the
# trunk's gradients are zero, as under the JAX package's stop_gradient
@pytest.mark.parametrize("clipped", [False, True])
def test_three_optimizer_steps_match_optax(clipped):
    v, tm = _model()
    kw = dict(batch_size=4, lr=2e-3, l2=1e-2, clip=0.5 if clipped else 1e4,
              steps=(0,), lr_decay=0.3)
    state = create_train_state(JConfig(**kw), v, steps_per_epoch=2)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    opt = Optimizer(Config(device="cpu", **kw), tm, steps_per_epoch=2)
    live = dict(tm.named_parameters())
    rng = np.random.RandomState(2)
    for i in range(3):
        grads = jax.tree_util.tree_map_with_path(
            lambda path, p: np.zeros_like(p) if "trunk" in str(path[0])
            else (rng.randn(*p.shape) * 0.05).astype(np.float32),
            v["params"])
        norm = np.sqrt(sum(float(np.square(g).sum())
                           for g in jax.tree_util.tree_leaves(grads)))
        assert (norm > 0.5) if clipped else (norm < 1e4)
        state = apply(state, grads)
        for k, g in variables_from_jax({"params": grads}).items():
            if live[k].requires_grad:
                live[k].grad = g.clone()
        got_norm = float(opt.apply_gradients())
        assert abs(got_norm - norm) <= 1e-5 * norm
        want = variables_from_jax({"params": jax.tree_util.tree_map(
            np.asarray, state.params)})
        for k, w in want.items():
            p = live[k].detach().numpy()
            err = np.abs(p - w.numpy()).max() / np.abs(w.numpy()).max()
            assert err <= 1e-6, (i, k, err)
