"""The dense configs that need no new module — ``gemma3-27b`` (5:1
sliding-window:global attention, GQA 2:1 at smoke size), ``llama3-405b``
(GQA, Adafactor) and ``minitron-8b`` (GQA) — at smoke size in both modes,
against the JAX package: logits within ``rtol=atol=1e-4`` and the loss
within ``rtol=1e-5``, from JAX's initial parameters carried across as
numpy.  f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.models.factory import build as jax_build
from repro_torch.configs import smoke_config
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.factory import build

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["aaren", "softmax"])
@pytest.mark.parametrize("arch", ["gemma3-27b", "llama3-405b",
                                  "minitron-8b"])
def test_dense_config_logits_and_loss_match_jax(arch, mode):
    """12 tokens: past gemma3's smoke window of 8 in softmax mode."""
    jcfg = jax_smoke_config(arch, attn_mode=mode)
    japi = jax_build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = smoke_config(arch, attn_mode=mode)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 12)).astype(
        np.int32)
    jlogits, jloss = jax.jit(lambda p, t: (
        jlm.lm_apply(jcfg, p, t)[0],
        japi.loss(p, {"tokens": t, "loss_mask": jnp.ones(t.shape)})[0]))(
            jparams, jnp.asarray(toks))
    t = torch.as_tensor(toks)
    logits, _ = lm.lm_apply(cfg, params, t)
    loss, _ = build(cfg).loss(params, {"tokens": t})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
