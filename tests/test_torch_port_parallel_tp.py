"""The port's tensor-parallel cuts on eight gloo ranks of the CPU against
the JAX package's unsharded loss, grad norm and gradients, as
``tests/test_train_step.py::test_tp2_matches_tp1_and_unsharded`` holds
JAX's meshes to them; then the rank-to-(data, model) map and the loader's
shards by data rank on a tp2 mesh.

One launch of eight ranks (``_torch_parallel_ranks.tp_ranks``) runs the
meshes ``dp4`` (tp1, on ranks 0-3), ``dp4_tp2`` and ``dp2_tp4`` (one head
of tiny's four per rank) in turn, each data rank on its rows of the
global batch of 4, f32 with dropout 0. Each data rank's criterion keeps
the heatmap's bare sum (``dp_size`` 1), so that their average is JAX's
criterion at ``dp_size = dp``, the JAX CLI's, which is the reference here.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from snipper_tpu.config import Config as JaxConfig
from snipper_tpu.losses.criterion import SetCriterion as JaxCriterion
from snipper_tpu.models import snipper as jsnipper
from snipper_tpu.train.state import mask_frozen_grads
from snipper_tpu_torch.config import Config
from snipper_tpu_torch.convert import state_dict_from_jax
from snipper_tpu_torch.data.snippet import stack_batch
from snipper_tpu_torch.data.synthetic import SyntheticDataset
from snipper_tpu_torch.parallel import multihost

sys.path.insert(0, os.path.dirname(__file__))
import _torch_parallel_ranks as ranks  # noqa: E402
from test_torch_port_train import TINY, _random_params  # noqa: E402

MESHES = ((4, 1), (4, 2), (2, 4))
N_ITEMS = 10


def _jax_parts(jcfg, params, host):
    """JAX's unsharded loss and gradients split into the heatmap term and
    the rest (one forward, two pullbacks), so that the criterion at any
    ``dp_size`` is ``rest + heatmap / dp_size``."""
    jm = jsnipper.build_model(jcfg)
    crit = JaxCriterion(jcfg)
    w_hm = crit.weights["loss_heatmap"]
    images = jnp.asarray(host["images"])
    targets = jax.tree_util.tree_map(jnp.asarray, host["targets"])

    def parts(p):
        total, losses, _ = crit(jm.apply({"params": p}, images), targets)
        hm = w_hm * losses["loss_heatmap"]
        return total - hm, hm

    @jax.jit
    def run(p):
        (rest, hm), pull = jax.vjp(parts, p)
        one = jnp.ones((), jnp.float32)
        zero = jnp.zeros((), jnp.float32)
        return rest, hm, pull((one, zero))[0], pull((zero, one))[0]

    rest, hm, g_rest, g_hm = run(jax.tree_util.tree_map(jnp.asarray, params))
    return (float(rest), float(hm),
            state_dict_from_jax(jax.device_get(mask_frozen_grads(g_rest))),
            state_dict_from_jax(jax.device_get(mask_frozen_grads(g_hm))))


@pytest.fixture(scope="module")
def tp():
    """``(rank results, JAX's rest and heatmap parts)``."""
    jcfg = JaxConfig.tiny().replace(**TINY)
    cfg = Config.tiny().replace(**TINY)
    jm = jsnipper.build_model(jcfg)
    x = jnp.zeros((1, jcfg.num_frames, jcfg.input_height, jcfg.input_width,
                   3), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    params = _random_params(shapes["params"], 5)
    ds = SyntheticDataset(cfg, n_samples=4, seed=0)
    host = stack_batch([ds[i] for i in range(4)])
    inp = {"state_dict": state_dict_from_jax(params),
           "batch": {k: v for k, v in host.items() if k != "meta"},
           "meshes": MESHES, "n_items": N_ITEMS}
    with ThreadPoolExecutor(1) as pool:
        launch = pool.submit(multihost.spawn, ranks.tp_ranks, 8, (inp,),
                             timeout_s=300)
        ref = _jax_parts(jcfg, params, host)
        res = launch.result()
    return res, ref


@pytest.mark.parametrize("dp,tp_size", MESHES)
def test_tp_matches_jax_unsharded(tp, dp, tp_size):
    """Each mesh's loss within 1e-4 and grad norm within 1e-3 (relative) of
    JAX's unsharded ones, JAX's own bounds
    (``tests/test_train_step.py:234-236``); the gathered full gradient of
    every parameter at rtol 1e-4, atol 1e-5 of the largest; every rank of
    the mesh holds the same loss and norm, and ``H / tp`` heads."""
    res, (rest, hm, g_rest, g_hm) = tp
    name = f"dp{dp}_tp{tp_size}"
    want_loss = rest + hm / dp
    want = {k: g_rest[k].numpy() + g_hm[k].numpy() / dp for k in g_rest}
    want_norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                            for g in want.values()))
    got = [r["meshes"][name] for r in res if name in r["meshes"]]
    assert len(got) == dp * tp_size
    for g in got:
        assert abs(g["loss"] - want_loss) / abs(want_loss) < 1e-4
        assert abs(g["grad_norm"] - want_norm) / want_norm < 1e-3
        assert g["heads"] == Config.tiny().nheads // tp_size
    assert len({g["loss"] for g in got}) == 1
    grads = got[0]["grads"]
    g_max = max(np.abs(g).max() for g in grads.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-5 * g_max,
                                   err_msg=k)


def test_mesh_places_rank_r_at_r_div_tp_r_mod_tp(tp):
    res, _ = tp
    for r, out in enumerate(res):
        m = out["map"]
        assert (m["rank"], m["data_rank"], m["model_rank"]) == (
            r, r // 2, r % 2)
        assert m["model_group"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert m["data_group"] == list(range(r % 2, 8, 2))


def test_loader_shards_by_data_rank_under_tp2(tp):
    """The ranks of one model group read the same shard; the four data
    ranks' shards are disjoint apart from the wrap-around padding and
    cover the set."""
    res, _ = tp
    shards = [out["shard"] for out in res]
    for r in range(0, 8, 2):
        assert shards[r] == shards[r + 1]
    by_data = shards[::2]
    assert all(len(s) == -(-N_ITEMS // 4) for s in by_data)
    flat = [i for s in by_data for i in s]
    assert sorted(set(flat)) == list(range(N_ITEMS))
    assert len(flat) - len(set(flat)) == 4 * -(-N_ITEMS // 4) - N_ITEMS
