"""The port's serving engines (``repro_torch.serving``) against the JAX
package's, and against each other.

Greedy decoding is compared token for token with the JAX package's
``StreamingEngine`` on the same parameters (carried across with
``params_from_jax``).  Seeded temperature sampling cannot reproduce
``jax.random``'s bits, so it is compared inside the port: streaming ==
wave generation under the same ``(request_id, step)`` seed schedule.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.factory import build as jax_build
from repro.serving import StreamingEngine as JaxStreamingEngine
from repro_torch.configs import smoke_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.factory import build
from repro_torch.models.lm import lm_state_init
from repro_torch.serving.engine import StreamingEngine, generate
from repro_torch.serving.sampler import temperature_sampler

SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=64)
PROMPT_LENS = [3, 9, 1, 6, 12, 5]
MAX_NEW = [5, 2, 7, 4, 3, 6]


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("phi3-mini-3.8b", **SMALL)
    japi = jax_build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build(smoke_config("phi3-mini-3.8b", **SMALL))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), api.cfg,
                             "cpu")
    return japi, jparams, api, params


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve(engine, prompts, max_new):
    rids = [engine.submit(p, m) for p, m in zip(prompts, max_new)]
    out = engine.run()
    return [list(map(int, out[r])) for r in rids]


def test_streaming_greedy_matches_jax_engine(models):
    """4 slots, chunk 4, 6 requests of unequal prompt and max_new: slots
    refill mid-flight.  Greedy tokens are identical to the JAX engine's."""
    japi, jparams, api, params = models
    prompts = _prompts(api.cfg.vocab, PROMPT_LENS)
    want = _serve(JaxStreamingEngine(japi, jparams, n_slots=4, chunk=4),
                  prompts, MAX_NEW)
    got = _serve(StreamingEngine(api, params, n_slots=4, chunk=4),
                 prompts, MAX_NEW)
    assert got == want
    assert [len(t) for t in got] == MAX_NEW


@pytest.mark.parametrize("sampler", [None, temperature_sampler(0.8, top_k=8)],
                         ids=["greedy", "temperature"])
def test_streaming_matches_wave(models, sampler):
    """Streaming == wave generation (ragged prompts), greedy and seeded."""
    _, _, api, params = models
    kw = {} if sampler is None else {"sampler": sampler}
    prompts = _prompts(api.cfg.vocab, PROMPT_LENS[:4], seed=1)
    padded = np.zeros((4, max(PROMPT_LENS[:4])), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :p.size] = p
    wave, _ = generate(api, params, padded, 5, seed=3,
                       prompt_lengths=PROMPT_LENS[:4], **kw)
    eng = StreamingEngine(api, params, n_slots=3, chunk=4, seed=3, **kw)
    assert _serve(eng, prompts, [5] * 4) == wave.tolist()


def test_freed_slot_carry_is_init_bitwise(models):
    """After completions, free slots hold the ⊕-identity init carry bit for
    bit — including ticks where they ran as all-padding rows."""
    _, _, api, params = models
    eng = StreamingEngine(api, params, n_slots=3, chunk=4)
    init = lm_state_init(api.cfg, 3, device="cpu")
    for p, m in zip(_prompts(api.cfg.vocab, [5, 2]), [2, 6]):
        eng.submit(p, m)
    saw_free_slot = False
    while eng.queue or any(s is not None for s in eng.active):
        eng.step()
        for i, slot in enumerate(eng.active):
            if slot is None:
                saw_free_slot = True
                for got, want in zip(eng.states, init):
                    for a, b in zip(got, want):
                        assert torch.equal(a[i], b[i])
    assert saw_free_slot
    for got, want in zip(eng.states, init):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_engine_and_generate_validate_inputs(models):
    _, _, api, params = models
    eng = StreamingEngine(api, params, n_slots=2, chunk=4)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.zeros(0, np.int32), 3)
    with pytest.raises(ValueError, match="integers"):
        eng.submit(np.zeros(3, np.float32), 3)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.zeros(3, np.int32), 0)
    with pytest.raises(ValueError, match="prompt_lengths"):
        generate(api, params, np.zeros((2, 4), np.int32), 2,
                 prompt_lengths=[5, 1])
    softmax = build(smoke_config("phi3-mini-3.8b", attn_mode="softmax",
                                 **SMALL))
    with pytest.raises(ValueError, match="KV-cache models"):
        StreamingEngine(softmax, params)
    rglru = build(smoke_config("phi3-mini-3.8b", pattern=("rglru",), **SMALL))
    with pytest.raises(ValueError, match="all-Aaren"):
        StreamingEngine(rglru, params)


@pytest.mark.parametrize("engine", ["streaming", "wave"])
def test_serve_launcher_runs_on_cpu(engine, capsys):
    serve.main(["--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
                "--engine", engine, "--requests", "3", "--slots", "2",
                "--prompt-len", "5", "--chunk", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert f"[{engine}]" in out and "9 tokens" in out
