"""``sgg_torch.convert``: the flax -> torch weight mapping is total, keeps
every element, and loads with ``strict=True``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.train.assign import all_pairs
from sgg_torch.convert import variables_from_jax
from sgg_torch.models.relhead import RelModelIMP


def _flax_leaves(use_bias):
    jm = JModel(num_classes=9, num_predicates=6, hidden_dim=16, obj_dim=32,
                use_bias=use_bias, dtype=jnp.float32)
    nm = jnp.ones((1, 3), bool)
    pairs, pm = all_pairs(nm)
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 3, 4)),
                            jnp.ones((1, 3), jnp.int32), pairs, pm)
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("use_bias", [False, True])
def test_converter_is_total_and_loads_strict(use_bias):
    variables = _flax_leaves(use_bias)
    sd = variables_from_jax(variables)
    leaves = jax.tree_util.tree_leaves(variables)
    flax_only = {k: v for k, v in sd.items()
                 if not k.endswith("num_batches_tracked")}
    assert len(flax_only) == len(leaves)
    assert sum(v.numel() for v in flax_only.values()) == \
        sum(x.size for x in leaves)

    tm = RelModelIMP(num_classes=9, num_predicates=6, hidden_dim=16,
                     obj_dim=32, use_bias=use_bias)
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert sd[k].shape == v.shape, k
    tm.load_state_dict(sd, strict=True)


def test_converter_layouts():
    variables = _flax_leaves(True)
    sd = variables_from_jax(variables)
    p = variables["params"]
    # conv HWIO -> OIHW, dense (in, out) -> (out, in), GRU gates, BN
    np.testing.assert_array_equal(
        sd["trunk.conv.0.weight"].numpy(),
        p["trunk"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["roi_fmap.fc6.weight"].numpy(),
                                  p["roi_fmap"]["fc6"]["kernel"].T)
    np.testing.assert_array_equal(sd["imp.edge_gru.weight_hh"].numpy(),
                                  p["imp"]["edge_gru"]["hh"]["kernel"].T)
    np.testing.assert_array_equal(sd["imp.node_gru.bias_ih"].numpy(),
                                  p["imp"]["node_gru"]["ih"]["bias"])
    np.testing.assert_array_equal(
        sd["union_feats.bn2.running_var"].numpy(),
        variables["batch_stats"]["union_feats"]["bn2"]["var"])
    np.testing.assert_array_equal(sd["union_feats.bn1.weight"].numpy(),
                                  p["union_feats"]["bn1"]["scale"])
    np.testing.assert_array_equal(sd["freq_bias.table"].numpy(),
                                  p["freq_bias"]["table"])
    assert sd["union_feats.bn1.num_batches_tracked"].dtype == torch.long
