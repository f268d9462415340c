"""The port's guarded numerics, checkpoint adversity and preemption
(``repro_torch.train.guard``, ``checkpoint``, ``testing.faults``,
``train.loop``) against the JAX package: the training half of
``tests/test_fault_tolerance.py``.

Model: ``smoke_config("phi3-mini-3.8b", n_layers=1)`` in f32, JAX
parameters carried across by ``params_from_jax``, batches of 2 x 16 from
both packages' ``SyntheticLMIterator`` (bit-equal, ``test_torch_train.py``).
Bars: the guard's carry exactly; the guarded loop's counters and skipped
steps exactly and its losses within rtol 1e-5 (the suite's loss bar); a
fault-free guarded run and a resumed run bit-identical to their
references.
"""

import signal
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data.synthetic import SyntheticLMIterator as JaxIterator
from repro.models.factory import build as jax_build
from repro.testing import FaultyLMIterator as JaxFaulty
from repro.testing import faulty_loss as jax_faulty_loss
from repro.train import guard as jguard
from repro.train.loop import LoopConfig as JaxLoopConfig
from repro.train.loop import run_train_loop as jax_run_train_loop
from repro.train.optim import make_optimizer as jax_make_optimizer
from repro.train.optim import warmup_cosine as jax_warmup_cosine
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.state import make_train_step as jax_make_train_step
from repro_torch.checkpoint import (
    CheckpointCorruptionError,
    available_steps,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import smoke_config
from repro_torch.data.synthetic import SyntheticLMIterator
from repro_torch.models.convert import params_from_jax
from repro_torch.models.factory import build
from repro_torch.testing import (
    FAULT_KINDS,
    FaultyLMIterator,
    PreemptingIterator,
    checkpoint_crc_ok,
    corrupt_checkpoint,
    faulty_loss,
    send_preemption,
)
from repro_torch.train import guard as tguard
from repro_torch.train.loop import LoopConfig, run_train_loop
from repro_torch.train.optim import make_optimizer, warmup_cosine
from repro_torch.train.state import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

DATA = dict(seq_len=16, batch=2, seed=0)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_smoke_config("phi3-mini-3.8b", n_layers=1)
    cfg = smoke_config("phi3-mini-3.8b", n_layers=1)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, build(cfg), np_params


def _params(model):
    """A fresh copy of the JAX initial parameters (the step writes in
    place)."""
    _, _, cfg, _, np_params = model
    return params_from_jax(np_params, cfg, "cpu")


def _data(model):
    return SyntheticLMIterator(vocab=model[2].vocab, **DATA)


def _opt(total=20):
    return make_optimizer("adamw", warmup_cosine(2e-3, 2, total))


def _guarded(model, guard=None, **step_kw):
    guard = guard or tguard.GuardConfig()
    opt = _opt()
    state = init_train_state(_params(model), opt, guard=guard)
    step = make_train_step(faulty_loss(model[3].loss), opt, guard=guard,
                           **step_kw)
    return state, step


def _loop(total, **kw):
    return LoopConfig(total_steps=total, log_every=1,
                      install_signal_handlers=False, **kw)


def _params_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The guard carry against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skip_on_spike", [False, True])
def test_guard_update_matches_jax_exactly(skip_on_spike):
    """One seeded sequence of (finite, gnorm) — NaN steps, spikes, long
    finite runs — through both packages' guard_update: apply, spike,
    lr_scale, the counters and the window agree exactly at every step."""
    kw = dict(recover_every=4, spike_window=6, spike_min_history=3,
              spike_factor=3.0, skip_on_spike=skip_on_spike)
    jcfg, tcfg = jguard.GuardConfig(**kw), tguard.GuardConfig(**kw)
    jg, tg = jguard.init_guard_state(jcfg), tguard.init_guard_state(tcfg)
    rng = np.random.default_rng(7)
    jupdate = jax.jit(lambda g, f, n: jguard.guard_update(jcfg, g, f, n))
    n_skip = n_spike = 0
    for _ in range(60):
        finite = bool(rng.random() > 0.15)
        gnorm = np.float32(rng.lognormal(0.0, 0.3)
                           * (8.0 if rng.random() < 0.1 else 1.0))
        if not finite:
            gnorm = np.float32(np.nan)
        jg, japply, jspike = jupdate(jg, np.bool_(finite), gnorm)
        tg, tapply, tspike = tguard.guard_update(
            tcfg, tg, torch.tensor(finite), torch.tensor(gnorm))
        assert bool(tapply) == bool(japply)
        assert bool(tspike) == bool(jspike)
        n_skip += not bool(tapply)
        n_spike += bool(tspike)
        for name in tguard.GuardState._fields:
            got = getattr(tg, name).numpy()
            want = np.asarray(getattr(jg, name))
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert n_skip >= 5 and n_spike >= 1     # the sequence exercised both
    assert float(tg.lr_scale) < 1.0 or int(tg.skipped) > 0


def test_guarded_loop_matches_jax(model):
    """FaultyLMIterator(nan_at={2}) with a 1e4 scale at step 9 (a spike):
    the same skipped and spike steps, final lr_scale and skipped-step
    indices as JAX's loop, and the losses within rtol 1e-5."""
    jcfg, jparams, cfg, api, _ = model
    steps, nan_at, scale_at = 12, {2}, {9: 1e4}
    gkw = dict(spike_min_history=4)

    jg = jguard.GuardConfig(**gkw)
    jopt = jax_make_optimizer("adamw", jax_warmup_cosine(2e-3, 2, 20))
    jstate = jax_init_train_state(jparams, jopt, guard=jg)
    jstep = jax.jit(jax_make_train_step(jax_faulty_loss(jax_build(jcfg).loss),
                                        jopt, guard=jg))
    want = jax_run_train_loop(
        jstep, jstate,
        JaxFaulty(JaxIterator(vocab=cfg.vocab, **DATA), nan_at=nan_at,
                  scale_at=scale_at),
        JaxLoopConfig(total_steps=steps, log_every=1, guard=True,
                      install_signal_handlers=False))

    state, step = _guarded(model, tguard.GuardConfig(**gkw))
    got = run_train_loop(
        step, state,
        FaultyLMIterator(_data(model), nan_at=nan_at, scale_at=scale_at),
        _loop(steps, guard=True))

    def skipped(res):
        return [s for s, m in res.history if m["guard_skipped"]]

    assert skipped(got) == skipped(want) == [2]
    assert (got.skipped_steps, got.spike_steps) == (
        want.skipped_steps, want.spike_steps) == (1, 1)
    assert got.final_lr_scale == want.final_lr_scale == 0.5
    np.testing.assert_allclose([m["loss"] for _, m in got.history],
                               [m["loss"] for _, m in want.history],
                               rtol=1e-5, equal_nan=True)
    assert np.isnan(got.history[2][1]["grad_norm"])
    for p in tree_leaves(got.state.params):
        assert torch.isfinite(p).all()


# ---------------------------------------------------------------------------
# Guarded numerics in the port
# ---------------------------------------------------------------------------


def test_guard_faultfree_params_bit_identical(model):
    """With no faults the guarded step's parameters are byte-identical to
    the unguarded step's (the update is the same; x * lr_scale=1.0 is
    exact)."""
    api = model[3]
    opt = _opt()
    guard = tguard.GuardConfig()
    plain = make_train_step(api.loss, opt)
    guarded = make_train_step(api.loss, opt, guard=guard)
    s1 = init_train_state(_params(model), opt)
    s2 = init_train_state(_params(model), opt, guard=guard)
    it1, it2 = _data(model), _data(model)
    for _ in range(5):
        s1, _ = plain(s1, next(it1))
        s2, m2 = guarded(s2, next(it2))
        assert float(m2["guard_skipped"]) == 0.0
    _params_equal(s1.params, s2.params)
    _params_equal(s1.opt_state, s2.opt_state)


def test_guard_skip_leaves_params_and_moments_untouched(model):
    """The skipped step writes nothing: parameters and AdamW moments equal
    their values before it, bit for bit, and the step still advances."""
    state, step = _guarded(model)
    it = FaultyLMIterator(_data(model), nan_at={1})
    state, _ = step(state, next(it))
    before = [t.clone() for t in tree_leaves((state.params,
                                              state.opt_state))]
    state, m = step(state, next(it))
    assert float(m["guard_skipped"]) == 1.0 and state.step == 2
    assert float(state.guard.lr_scale) == 0.5
    for a, b in zip(before, tree_leaves((state.params, state.opt_state))):
        assert torch.equal(a, b)


def test_guard_lr_backoff_recovers(model):
    """After recover_every finite steps the backoff unwinds to 1.0."""
    state, step = _guarded(model, tguard.GuardConfig(recover_every=3))
    res = run_train_loop(step, state,
                         FaultyLMIterator(_data(model), nan_at={1}),
                         _loop(6, guard=True))
    assert res.skipped_steps == 1
    assert [m["guard_lr_scale"] for _, m in res.history] == [
        1.0, 0.5, 0.5, 0.5, 1.0, 1.0]
    assert res.final_lr_scale == 1.0


def test_guard_flags_grad_norm_spike(model):
    """A finite 1e4x loss at step 6 is flagged as a spike and, with
    skip_on_spike=False, still applied."""
    state, step = _guarded(model, tguard.GuardConfig(spike_min_history=4))
    res = run_train_loop(step, state,
                         FaultyLMIterator(_data(model), scale_at={6: 1e4}),
                         _loop(8, guard=True))
    assert res.spike_steps == 1 and res.skipped_steps == 0


def test_guard_skip_on_spike(model):
    """With skip_on_spike=True the spike step's update is skipped too,
    without an LR backoff."""
    state, step = _guarded(model, tguard.GuardConfig(
        spike_min_history=4, skip_on_spike=True))
    res = run_train_loop(step, state,
                         FaultyLMIterator(_data(model), scale_at={6: 1e4}),
                         _loop(8, guard=True))
    assert res.spike_steps == 1
    assert [s for s, m in res.history if m["guard_skipped"]] == [6]
    assert res.final_lr_scale == 1.0


def test_guard_survives_microbatching(model):
    """The 0-d ``_fault_scale`` rides through the microbatch split and
    still poisons the whole step."""
    state, step = _guarded(model, n_microbatches=2)
    res = run_train_loop(step, state,
                         FaultyLMIterator(_data(model), nan_at={2}),
                         _loop(4, guard=True))
    assert res.skipped_steps == 1
    for p in tree_leaves(res.state.params):
        assert torch.isfinite(p).all()


def test_loop_guard_flag_requires_guarded_step(model):
    """LoopConfig.guard=True with an unguarded step fails fast."""
    opt = _opt()
    step = make_train_step(model[3].loss, opt)
    with pytest.raises(ValueError, match="guard"):
        run_train_loop(step, init_train_state(_params(model), opt),
                       _data(model), _loop(2, guard=True))


def test_guard_requires_guarded_state(model):
    """make_train_step(guard=...) on a guard-less TrainState names the fix
    instead of training unguarded."""
    opt = _opt()
    step = make_train_step(model[3].loss, opt, guard=tguard.GuardConfig())
    with pytest.raises(ValueError, match="init_train_state"):
        step(init_train_state(_params(model), opt), next(_data(model)))


def test_all_finite_reads_leaves_not_the_norm():
    """Finite bf16 values whose f32 squares overflow are finite; any NaN or
    inf leaf is not; integer leaves count as finite."""
    big = torch.full((4,), 3e19, dtype=torch.bfloat16)
    assert torch.isinf(big.float().square().sum())
    assert bool(tguard.all_finite(torch.tensor(1.0), {"g": big},
                                  [torch.arange(3)]))
    for bad in (float("nan"), float("inf"), -float("inf")):
        x = torch.zeros(5)
        x[3] = bad
        assert not bool(tguard.all_finite(torch.tensor(1.0), {"g": x}))
    assert not bool(tguard.all_finite(torch.tensor(float("nan"))))


def test_guard_state_checkpoints_and_resumes(model):
    """Crash after a backoff: the resumed run carries the reduced lr_scale
    (GuardState lives in TrainState) and lands on the same parameters as an
    uninterrupted faulty run, bit for bit."""
    def faulty():
        return FaultyLMIterator(_data(model), nan_at={2, 6})

    state, step = _guarded(model)
    ref = run_train_loop(step, state, faulty(), _loop(8, guard=True))
    assert ref.skipped_steps == 2
    with tempfile.TemporaryDirectory() as d:
        lc = _loop(8, ckpt_dir=d, save_every=2, guard=True)
        state, step = _guarded(model)
        with pytest.raises(KeyboardInterrupt):
            run_train_loop(step, state, faulty(), lc,
                           _test_hooks={"crash_at": 4})
        state, step = _guarded(model)
        res = run_train_loop(step, state, faulty(), lc)
        assert res.resumed_from == 4
        assert res.final_lr_scale == 0.25   # halved at 2, again at 6
        assert int(res.state.guard.skipped) == 2
        _params_equal(res.state.params, ref.state.params)


# ---------------------------------------------------------------------------
# Checkpoint adversity
# ---------------------------------------------------------------------------


def _ckpt_tree(offset=0.0):
    return {"w": torch.arange(100, dtype=torch.float32).reshape(10, 10)
            + offset,
            "b": torch.ones(7) * (1 + offset)}


@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_restore_falls_back_past_corrupt_newest(kind):
    """Whatever breaks the newest step — bit rot, torn write, missing file,
    killed before the manifest — restore lands on the newest intact step;
    a stale staging dir of a killed save is never a candidate."""
    with tempfile.TemporaryDirectory() as d:
        for s in (10, 20, 30):
            save_checkpoint(d, s, _ckpt_tree(s))
        corrupt_checkpoint(d, 30, kind)
        want = 30 if kind == "stale_tmp" else 20
        got, step, _ = restore_checkpoint(d, _ckpt_tree())
        assert step == want
        assert torch.equal(got["w"], _ckpt_tree(want)["w"])
        assert available_steps(d) == [10, 20, 30]


def test_flip_byte_caught_by_crc():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, _ckpt_tree())
        assert checkpoint_crc_ok(d, 1)
        corrupt_checkpoint(d, 1, "flip_byte")
        assert not checkpoint_crc_ok(d, 1)
        with pytest.raises(CheckpointCorruptionError, match="crc"):
            restore_checkpoint(d, _ckpt_tree(), step=1)


def test_explicit_step_never_falls_back():
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2):
            save_checkpoint(d, s, _ckpt_tree(s))
        corrupt_checkpoint(d, 2, "truncate_chunk")
        with pytest.raises(CheckpointCorruptionError):
            restore_checkpoint(d, _ckpt_tree(), step=2)


def test_every_candidate_corrupt_reports_all_failures():
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2):
            save_checkpoint(d, s, _ckpt_tree(s))
        corrupt_checkpoint(d, 1, "delete_manifest")
        corrupt_checkpoint(d, 2, "truncate_chunk")
        with pytest.raises(CheckpointCorruptionError,
                           match="every candidate failed"):
            restore_checkpoint(d, _ckpt_tree())


def test_loop_resumes_past_corrupt_checkpoint(model):
    """Crash, corrupt the newest checkpoint, restart: the loop resumes from
    the older intact step and still finishes."""
    with tempfile.TemporaryDirectory() as d:
        lc = _loop(6, ckpt_dir=d, save_every=2, guard=True)
        state, step = _guarded(model)
        with pytest.raises(KeyboardInterrupt):
            run_train_loop(step, state, FaultyLMIterator(_data(model)), lc,
                           _test_hooks={"crash_at": 4})
        corrupt_checkpoint(d, 4, "flip_byte")
        state, step = _guarded(model)
        res = run_train_loop(step, state, FaultyLMIterator(_data(model)), lc)
        assert res.resumed_from == 2 and res.state.step == 6


# ---------------------------------------------------------------------------
# Preemption (real signals)
# ---------------------------------------------------------------------------


def test_sigterm_drains_and_resumes_bit_identical(model):
    """A real SIGTERM mid-run: the in-flight step finishes, one sync
    checkpoint is written, the loop exits; the restart lands on the same
    parameters as an uninterrupted run, bit for bit."""
    api = model[3]
    opt = _opt()
    step = make_train_step(api.loss, opt)
    ref = run_train_loop(step, init_train_state(_params(model), opt),
                         _data(model), _loop(6))
    with tempfile.TemporaryDirectory() as d:
        lc = LoopConfig(total_steps=6, ckpt_dir=d, save_every=100)
        it = PreemptingIterator(_data(model), preempt_after=3)
        res1 = run_train_loop(step, init_train_state(_params(model), opt),
                              it, lc)
        assert res1.preempted and res1.preempt_signal == signal.SIGTERM
        assert res1.state.step == 3 and available_steps(d) == [3]
        it2 = PreemptingIterator(_data(model), preempt_after=10 ** 9)
        res2 = run_train_loop(step, init_train_state(_params(model), opt),
                              it2, lc)
        assert res2.resumed_from == 3 and res2.state.step == 6
        assert not res2.preempted
        _params_equal(res2.state.params, ref.state.params)
        _params_equal(res2.state.opt_state, ref.state.opt_state)


def test_second_signal_cuts_the_drain_short(model):
    """Grace period revoked: a second signal during the drain raises
    immediately, and the previous handlers are restored."""
    opt = _opt()
    step = make_train_step(model[3].loss, opt)
    before = signal.getsignal(signal.SIGTERM)

    def on_log(s, m):
        if s == 1:
            send_preemption()
            send_preemption()   # second delivery raises in the handler

    with pytest.raises(KeyboardInterrupt, match="second signal"):
        run_train_loop(step, init_train_state(_params(model), opt),
                       _data(model), LoopConfig(total_steps=6, log_every=1),
                       on_log=on_log)
    assert signal.getsignal(signal.SIGTERM) is before
