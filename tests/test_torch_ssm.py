"""The port's Mamba2 (``repro_torch.models.ssm``) and its serving path
against ``repro.models.ssm``, with the JAX weights carried across by
``repro_torch.convert`` and the same numpy inputs on both sides:

- ``ssd_scan`` (S not a multiple of the chunk, a given initial state, one
  and two B/C groups) to rtol 1e-4 / atol 1e-5;
- mamba2-smoke: leaf names and shapes, ``forward`` / ``loss_fn``,
  ``prefill`` (prompt 20: three chunks of 8, the last padded) and 4
  ``decode_step``s, logits and caches, to rtol 1e-4 / atol 1e-5 (f32 sums
  run in another order on the two sides);
- one layer at mamba2-2.7b's published widths (vocab cut to 1024 to keep
  the CPU's memory small; nothing else is cut): ``prefill`` at prompt 300
  (two chunks of 256, the last padded) and 2 decode steps, to rtol 1e-4 /
  atol 1e-4 (d_model 2560 sums);
- the ``Server`` and ``launch/serve.py`` on the CPU give the model's own
  logits.
On the CPU the port's SSD kernel takes its plain version; the card's kernel
is held against it in ``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_2_7b as j_mamba
from repro.models import layers as jL
from repro.models import ssm as j_ssm
from repro_torch.configs import mamba2_2_7b as t_mamba
from repro_torch.convert import params_from_jax
from repro_torch.dist.serve import Server
from repro_torch.launch import serve as t_serve
from repro_torch.models import config as t_config
from repro_torch.models import layers as tL
from repro_torch.models import registry
from repro_torch.models import ssm as t_ssm
from repro_torch.tree import leaves_with_path

TOL = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _scan_inputs(bsz, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, s, h, p))
    dt = np.log1p(np.exp(rng.normal(size=(bsz, s, h)) - 1.0))
    a_log = np.log(np.linspace(1.0, 16.0, h))
    b = rng.normal(size=(bsz, s, g, n))
    c = rng.normal(size=(bsz, s, g, n))
    st = rng.normal(size=(bsz, h, p, n))
    return [a.astype(np.float32) for a in (x, dt, a_log, b, c, st)]


@pytest.mark.parametrize("g,s,chunk,with_state", [
    (1, 20, 8, False),    # S not a multiple of Q: the last chunk padded
    (1, 20, 8, True),
    (2, 20, 8, True),     # two groups: the kernel once per group
    (2, 16, 16, False),   # one chunk
    (1, 5, 8, True),      # S < chunk: Q = S
])
def test_ssd_scan_matches_jax(g, s, chunk, with_state):
    x, dt, a_log, b, c, st = _scan_inputs(2, s, 6, 4, g, 5, seed=s + g)
    init = st if with_state else None
    yj, sj = j_ssm.ssd_scan(*(jnp.asarray(a) for a in (x, dt, a_log, b, c)),
                            chunk=chunk, init_state=(
                                None if init is None else jnp.asarray(init)))
    t = [torch.from_numpy(a) for a in (x, dt, a_log, b, c)]
    yt, stt = t_ssm.ssd_scan(*t, chunk=chunk, init_state=(
        None if init is None else torch.from_numpy(init)))
    assert yt.shape == (2, s, 6, 4) and stt.shape == (2, 6, 4, 5)
    _close(yt, yj)
    _close(stt, sj)


# ------------------------------------------------------------ mamba2-smoke --
@pytest.fixture(scope="module")
def smoke():
    jcfg = j_mamba.smoke_config()
    tcfg = t_mamba.smoke_config()
    jp = j_ssm.init(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 24))
    return jcfg, tcfg, jp, tp, tokens.astype(np.int32)


def test_leaf_names_shapes_and_count(smoke):
    jcfg, tcfg, jp, tp, _ = smoke
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    want = [(tuple(k.key for k in path), tuple(a.shape)) for path, a in flat]
    assert [(p, tuple(a.shape)) for p, a in leaves_with_path(tp)] == want
    own = t_ssm.init(torch.Generator().manual_seed(0), tcfg)
    assert [(p, tuple(a.shape)) for p, a in leaves_with_path(own)] == want
    n = sum(a.numel() for _, a in leaves_with_path(own))
    assert t_config.num_params(tcfg) == n
    assert t_config.num_params(t_mamba.config()) == 2_831_296_000
    assert registry.get_model(registry.get_config(
        "mamba2-2.7b", smoke=True)) is t_ssm


def test_forward_and_loss_match_jax(smoke):
    jcfg, tcfg, jp, tp, tokens = smoke
    hj = j_ssm.forward(jp, jnp.asarray(tokens), jcfg)
    ht = t_ssm.forward(tp, torch.from_numpy(tokens), tcfg)
    _close(ht, hj)
    _close(tL.unembed(tp["embed"], ht, tcfg),
           jL.unembed(jp["embed"], hj, jcfg))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    lj = j_ssm.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                       jcfg)
    lt = t_ssm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                       tcfg)
    _close(lt, lj, rtol=1e-5, atol=0)


def _prefill_decode(jcfg, tcfg, jp, tp, tokens, split, steps, tol):
    """prefill tokens[:, :split], then teacher-forced decode steps on
    tokens[:, split:split + steps]; logits and caches against JAX."""
    lj, cj = j_ssm.prefill(jp, jnp.asarray(tokens[:, :split]), jcfg)
    lt, ct = t_ssm.prefill(tp, torch.from_numpy(tokens[:, :split]), tcfg)
    _close(lt, lj, **tol)
    for k in ("conv", "state"):
        assert ct[k].shape == cj[k].shape
        _close(ct[k], cj[k], **tol)
    for i in range(split, split + steps):
        pos = np.full((tokens.shape[0],), i, np.int32)
        lj, cj = j_ssm.decode_step(jp, jnp.asarray(tokens[:, i]), cj,
                                   jnp.asarray(pos), jcfg)
        lt, ct = t_ssm.decode_step(tp, torch.from_numpy(tokens[:, i]), ct,
                                   torch.from_numpy(pos), tcfg)
        _close(lt, lj, **tol)
        for k in ("conv", "state"):
            _close(ct[k], cj[k], **tol)


def test_prefill_and_decode_match_jax(smoke):
    jcfg, tcfg, jp, tp, tokens = smoke
    _prefill_decode(jcfg, tcfg, jp, tp, tokens, 20, 4, TOL)


def test_one_layer_at_published_widths_matches_jax():
    jcfg = dataclasses.replace(j_mamba.config(), n_layers=1, vocab=1024)
    tcfg = dataclasses.replace(t_mamba.config(), n_layers=1, vocab=1024)
    jp = j_ssm.init(jax.random.PRNGKey(5), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(6).integers(0, 1024, (1, 302))
    _prefill_decode(jcfg, tcfg, jp, tp, tokens.astype(np.int32), 300, 2,
                    dict(rtol=1e-4, atol=1e-4))


# ----------------------------------------------------------------- serving --
def test_server_and_cli_give_the_models_logits(smoke):
    args = t_serve.parse_args(["--smoke", "--device", "cpu", "--batch", "2",
                               "--prompt-len", "20", "13", "--gen-len", "3"])
    out = t_serve.run(args)
    cfg, params = out["cfg"], out["params"]
    assert len(out["requests"]) == 2
    for tokens, res in out["requests"]:
        assert tokens.shape[0] == 2
        with torch.no_grad():
            lg, cache = t_ssm.prefill(params, tokens, cfg)
            _close(res["prefill_logits"], lg, rtol=0, atol=0)
            tok = res["tokens"]
            assert tok.shape == (2, 4)
            assert torch.equal(tok[:, 0], torch.argmax(lg, -1))
            for i in range(3):
                lg, cache = t_ssm.decode_step(params, tok[:, i], cache,
                                              None, cfg)
                _close(res["decode_logits"][i], lg, rtol=0, atol=0)
                assert torch.equal(tok[:, i + 1], torch.argmax(lg, -1))
    server = Server(model=t_ssm, cfg=cfg, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="batch of 3"):
        server.prefill(params, {"tokens": torch.zeros((3, 4), dtype=torch.long)})
