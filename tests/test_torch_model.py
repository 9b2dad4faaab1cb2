"""The port's whisper-tiny (smoke size) against ``repro.models.encdec``,
with the JAX weights carried across by ``repro_torch.convert``: the same leaf
names, shapes and flat (wire) order, the loss to rtol 1e-5 and the gradient
to rtol 1e-4 / atol 1e-6 (f32 sums run in another order on the two sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import whisper_tiny as j_whisper
from repro.data.pipeline import ExtraInputs, LMShardLoader
from repro.models import encdec as j_encdec
from repro_torch.configs import whisper_tiny as t_whisper
from repro_torch.convert import params_from_jax
from repro_torch.models import config as t_config
from repro_torch.models import encdec as t_encdec
from repro_torch.tree import ParamLayout, leaves_with_path


@pytest.fixture(scope="module")
def setup():
    jcfg = j_whisper.smoke_config(remat=False)
    tcfg = t_whisper.smoke_config()
    params = j_encdec.init(jax.random.PRNGKey(3), jcfg)
    loader = LMShardLoader(1, 2, 16, jcfg.vocab, seed=5)
    b = loader.next_batch()
    batch = {"tokens": b["tokens"][0], "labels": b["labels"][0],
             "frames": ExtraInputs.frames(1, 2, jcfg.encoder_frames,
                                          jcfg.d_model, seed=5)[0]}
    return jcfg, tcfg, params, batch


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(k.key for k in path), tuple(x.shape)) for path, x in flat]


def test_leaf_order_and_shapes(setup):
    jcfg, tcfg, params, _ = setup
    want = _jax_paths(params)
    np_params = jax.tree.map(np.asarray, params)
    carried = params_from_jax(np_params, "cpu")
    got = [(p, tuple(x.shape)) for p, x in leaves_with_path(carried)]
    assert got == want
    own = t_encdec.init(torch.Generator().manual_seed(0), tcfg)
    assert [(p, tuple(x.shape)) for p, x in leaves_with_path(own)] == want
    layout = ParamLayout.of(own)
    assert layout.size == t_config.num_params(tcfg)
    # the flat buffer is the concatenation of jax.tree.leaves
    flat_j = np.concatenate([np.asarray(x).reshape(-1)
                             for x in jax.tree.leaves(params)])
    np.testing.assert_array_equal(layout.flatten(carried).numpy(), flat_j)
    # views of the flat row are the leaves again
    views = layout.views(layout.flatten(carried))
    for (_, a), (_, b) in zip(leaves_with_path(views),
                              leaves_with_path(carried)):
        assert torch.equal(a, b)


def test_full_size_param_count():
    assert t_config.num_params(t_whisper.config()) == 56_355_840


def test_loss_and_grad_match(setup):
    jcfg, tcfg, params, batch = setup
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grad_j = jax.jit(jax.value_and_grad(
        lambda p: j_encdec.loss_fn(p, jbatch, jcfg)))(params)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    flat_params = {}
    for path, x in leaves_with_path(tparams):
        x.requires_grad_(True)
        flat_params[path] = x
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_t = t_encdec.loss_fn(tparams, tbatch, tcfg)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for (path, g), (jpath, _) in zip(
            jax.tree_util.tree_flatten_with_path(grad_j)[0],
            _jax_paths(params)):
        got = flat_params[tuple(k.key for k in path)].grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-4, atol=1e-6,
                                   err_msg=str(jpath))
