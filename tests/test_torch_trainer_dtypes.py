"""The port's trainer with narrower leaves against the jitted JAX step on
whisper-tiny-smoke, W = 4 on a chain at 4 bits, 3 steps from the same
state, batches and draws (the harness:
``test_torch_trainer.compare_with_jax``).

Cases:
- ``state_dtype=bf16``: every leaf bf16 on both sides.  The port keeps f32
  buffers and rounds the bf16 columns through bf16 where the JAX result
  takes that dtype, each operation as XLA:CPU rounds it (the gradient's
  terms and their sums, Adam's moments with bf16 constants, the update
  from the moments' last unrounded sums, the duals).  Bound: every bf16
  position within one bf16 ulp (at max(|port|, |JAX|)) at all but BF16_FRACS
  of the positions — seen 1.5e-5 / 1.2e-5 / 1.1e-4 after steps 0 / 1 / 2,
  from the data gradient, whose f32 sums differ by an ulp and now and then
  round to the other bf16 neighbour;
- a mixed tree: the decoder's MLP and the embeddings cast to bf16 in the
  init of both packages, the rest f32 (atol 1e-5 there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import whisper_tiny as j_whisper
from repro.dist import qgadmm as jq
from repro.models import encdec as j_encdec
from repro_torch.configs import whisper_tiny as t_whisper
from repro_torch.dist import qgadmm as tq
from repro_torch.models import encdec as t_encdec
from repro_torch.tree import dtype_of, leaves_with_path
from test_torch_trainer import compare_with_jax, configs

BF16_FRACS = (2e-5, 2e-5, 2e-4)


def _cast_some(tree, to_bf16=lambda a: a.astype(jnp.bfloat16)):
    """The decoder's MLP and the embedding tables cast by `to_bf16`."""
    dec = tree["decoder"]
    return {**tree,
            "decoder": {**dec, "mlp": {k: to_bf16(v)
                                       for k, v in dec["mlp"].items()}},
            "embed": {k: v if k == "ln_f" else to_bf16(v)
                      for k, v in tree["embed"].items()}}


def test_bf16_state_matches_jax():
    jd, td = configs(state_dtype=torch.bfloat16)
    ms = compare_with_jax(jd, td, BF16_FRACS)
    assert [float(m["skip_rate"]) for m in ms] == [0.0] * 3


def test_mixed_tree_matches_jax():
    jd, td = configs()
    compare_with_jax(jd, td, BF16_FRACS, init_cast=_cast_some)
    # the port's own init_state keeps the cast leaves' dtypes, as JAX's
    j = jq.init_state(lambda k: _cast_some(j_encdec.init(
        k, j_whisper.smoke_config())), jax.random.PRNGKey(0), jd)
    t = tq.init_state(lambda g: _cast_some(
        t_encdec.init(g, t_whisper.smoke_config()),
        lambda a: a.to(torch.bfloat16)), 0, td, device="cpu")
    want = [dtype_of(x) for _, x in leaves_with_path(
        jax.tree.map(np.asarray, j.theta))]
    assert list(t.layout.dtypes) == want and torch.bfloat16 in want
