"""The port's serving engines (``repro_torch.serving``) against the JAX
package's, and against each other.

Greedy decoding is compared token for token with the JAX package's
``StreamingEngine`` on the same parameters (carried across with
``params_from_jax``).  Seeded temperature sampling cannot reproduce
``jax.random``'s bits, so it is compared inside the port: streaming ==
wave generation under the same ``(request_id, step)`` seed schedule, one
sampler call a tick.  The slot copy-out/in primitives are held against the
JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import lm as jax_lm
from repro.models.factory import build as jax_build
from repro.serving import StreamingEngine as JaxStreamingEngine
from repro_torch.configs import smoke_config
from repro_torch.core.scan_attention import ScanState
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax, states_to_jax_layout
from repro_torch.models.factory import build
from repro_torch.models.lm import (
    lm_state_init,
    lm_state_put_slot,
    lm_state_take_slot,
)
from repro_torch.serving.engine import StreamingEngine, generate
from repro_torch.serving.sampler import (
    greedy_sampler,
    request_seed,
    request_seeds,
    temperature_sampler,
)

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
    with pytest.raises(ValueError, match="all-aaren"):
        StreamingEngine(rglru, params, chunk=4)


@pytest.mark.parametrize("engine", ["streaming", "wave"])
def test_serve_launcher_runs_on_cpu(engine, capsys):
    serve.main(["--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
                "--engine", engine, "--requests", "3", "--slots", "2",
                "--prompt-len", "5", "--chunk", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert f"[{engine}]" in out and "9 tokens" in out


def test_take_put_slot_match_jax_at_nslots_eq_nheads():
    """Slot ``idx`` of a random state, taken and put back into masked slots,
    equals the JAX package's ``lm_state_take_slot``/``put_slot`` — with
    n_slots == n_heads, where a shape-matching heuristic could address a
    head instead of a slot — and take round-trips through put unchanged."""
    kw = dict(SMALL, n_heads=4, n_kv_heads=4, head_dim=16)
    jcfg = jax_smoke_config("phi3-mini-3.8b", **kw)
    cfg = smoke_config("phi3-mini-3.8b", **kw)
    rng = np.random.default_rng(0)
    states = [ScanState(*(torch.from_numpy(rng.standard_normal(
        tuple(x.shape)).astype(np.float32)) for x in st))
        for st in lm_state_init(cfg, cfg.n_heads, device="cpu")]
    jstates = jax.tree.unflatten(
        jax.tree.structure(jax_lm.lm_state_init(jcfg, cfg.n_heads, 1)),
        [jnp.asarray(x) for x in jax.tree.leaves(
            states_to_jax_layout(cfg, states))])
    carry = lm_state_take_slot(states, 2)
    jcarry = jax_lm.lm_state_take_slot(jcfg, jstates, jnp.int32(2))
    for got, want in zip(jax.tree.leaves(states_to_jax_layout(cfg, carry)),
                         jax.tree.leaves(jcarry)):
        np.testing.assert_array_equal(got, np.asarray(want))
    mask = np.asarray([True, False, False, True])
    put = lm_state_put_slot(states, carry, torch.from_numpy(mask))
    jput = jax_lm.lm_state_put_slot(jcfg, jstates, jcarry, jnp.asarray(mask))
    for got, want in zip(jax.tree.leaves(states_to_jax_layout(cfg, put)),
                         jax.tree.leaves(jput)):
        np.testing.assert_array_equal(got, np.asarray(want))
    back = lm_state_put_slot(states, carry,
                             torch.tensor([False, False, True, False]))
    assert all(torch.equal(a, b) for sa, sb in zip(back, states)
               for a, b in zip(sa, sb))


def test_batched_sampler_one_call_a_tick(models):
    """A batched sampler is called once a tick over all slots, and the
    streaming engine's tokens equal wave generation's; a custom sampler
    is called once per sampled row with that row's seed."""
    _, _, api, params = models
    calls = []
    base = temperature_sampler(0.8, top_k=8)

    def counting(logits, seeds):
        calls.append(tuple(logits.shape))
        return base(logits, seeds)

    counting.batched = True
    prompts = _prompts(api.cfg.vocab, [4, 4, 4], seed=2)
    wave, _ = generate(api, params, np.stack(prompts), 4, seed=9,
                       sampler=base)
    eng = StreamingEngine(api, params, n_slots=3, chunk=4, seed=9,
                          sampler=counting)
    rids = [eng.submit(p, 4) for p in prompts]
    ticks = 0
    while eng.queue or any(s is not None for s in eng.active):
        eng.step()
        ticks += 1
    assert [eng.finished[r] for r in rids] == wave.tolist()
    assert calls == [(3, 1, api.cfg.vocab)] * ticks

    seen = []

    def per_row(logits, seeds):
        seen.append((tuple(logits.shape), int(seeds[0])))
        return base(logits, seeds)

    eng = StreamingEngine(api, params, n_slots=3, chunk=4, seed=9,
                          sampler=per_row)
    assert _serve(eng, prompts, [4] * 3) == wave.tolist()
    assert sorted(s for _, s in seen) == sorted(
        request_seed(9, r, t) for r in range(3) for t in range(4))
    assert {shape for shape, _ in seen} == {(1, 1, api.cfg.vocab)}


def test_greedy_sampler_gets_no_seeds(models, monkeypatch):
    """A sampler with ``uses_seeds = False`` is passed ``None`` and no seed
    is derived for it, in the streaming engine and in ``generate``; its
    tokens equal the default greedy engine's."""
    import repro_torch.serving.engine as engine_mod

    _, _, api, params = models
    prompts = _prompts(api.cfg.vocab, [4, 7, 2], seed=5)
    want = _serve(StreamingEngine(api, params, n_slots=2, chunk=4),
                  prompts, [3] * 3)
    seen = []

    def argmax(logits, seeds):
        seen.append(seeds)
        return greedy_sampler(logits, seeds)

    argmax.batched = True
    argmax.uses_seeds = False

    def no_seeds(*args):
        raise AssertionError("a seed was derived for a seedless sampler")

    monkeypatch.setattr(engine_mod, "request_seeds", no_seeds)
    monkeypatch.setattr(engine_mod, "request_seed", no_seeds)
    eng = StreamingEngine(api, params, n_slots=2, chunk=4, sampler=argmax)
    assert _serve(eng, prompts, [3] * 3) == want
    wave, _ = generate(api, params, np.stack([p[:2] for p in prompts]), 3,
                       sampler=argmax)
    assert wave.shape == (3, 3)
    assert seen and all(x is None for x in seen)


def test_sampler_seeds_and_distribution():
    """The seeds are the same bits on the host and in torch; greedy is
    argmax; Gumbel-max draws follow softmax(logits / T)."""
    rids, steps = torch.tensor([0, 1, 7, -1]), torch.tensor([0, 5, 2, 0])
    assert request_seeds(3, rids, steps).tolist() == [
        request_seed(3, r, t) for r, t in zip(rids.tolist(), steps.tolist())]
    logits = torch.tensor([[[0.5, 2.0, -1.0, 1.0, 0.0]]])
    assert greedy_sampler(logits).tolist() == [[1]]
    n = 20000
    seeds = request_seeds(0, torch.zeros(n, dtype=torch.int64),
                          torch.arange(n))
    draws = temperature_sampler(0.7)(logits.expand(n, 1, 5), seeds)[:, 0]
    freq = torch.bincount(draws, minlength=5).double() / n
    want = torch.softmax(logits[0, 0].double() / 0.7, dim=-1)
    assert (freq - want).abs().max() < 0.015
    top2 = temperature_sampler(1.0, top_k=2)(logits.expand(n, 1, 5), seeds)
    assert set(top2.flatten().tolist()) == {1, 3}


def test_serve_launcher_tier_flags_on_cpu(capsys, tmp_path):
    """The tier: two replicas, a drain, a shared prefix cache with a pinned
    prefix saved to a directory, deadlines and a bounded front queue."""
    argv = ["--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
            "--requests", "6", "--slots", "2", "--prompt-len", "9",
            "--chunk", "4", "--max-new", "3", "--replicas", "2",
            "--drain", "1", "--prefix-cache-mb", "1",
            "--prefix-cache-min-hits", "1", "--pin-prefix", "1,2,3,4,5",
            "--prefix-cache-dir", str(tmp_path / "pc"),
            "--deadline-s", "600", "--max-queue", "4"]
    serve.main(argv)
    out = capsys.readouterr().out
    assert "[router] drained replica 1" in out
    assert "6 requests / 18 tokens" in out
    assert "alive 1/2" in out and "shared prefix cache" in out
    serve.main(argv)             # the second run loads the saved cache
    assert "[router] prefix cache: restored step 0" in \
        capsys.readouterr().out
