"""The paper-table proxies on the port (``benchmarks/torch``) and their
generators (``repro_torch.data.synthetic``) against the JAX package's
(``benchmarks/bench_*.py``, ``repro.data.synthetic``), on the CPU.

* The generators and each proxy's batch function are bit-equal.
* Losses and metrics agree on the same predictions (rtol 1e-6); the JAX
  side is the JAX module's own code, driven through its ``run`` with
  ``train_model`` and ``backbone_apply`` replaced.
* The backbone on carried weights agrees with JAX's, both mixers (1e-5).
* ``_jax_train``, the JAX trainer's loop with per-step losses, gives the
  parameters of the JAX package's ``train_model``.

``tests/test_torch_tasks_train.py`` trains both packages three steps from
the same weights with the helpers here.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import bench_events as jev  # noqa: E402
from benchmarks import bench_rl as jrl  # noqa: E402
from benchmarks import bench_tsc as jtsc  # noqa: E402
from benchmarks import bench_tsf as jtsf  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from benchmarks.torch import bench_events, bench_rl, bench_tsc, bench_tsf  # noqa: E402
from benchmarks.torch import common  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

PROXIES = {"rl": (jrl, bench_rl), "events": (jev, bench_events),
           "tsf": (jtsf, bench_tsf), "tsc": (jtsc, bench_tsc)}
# Each proxy's output width (the backbone's head).
WIDTHS = {"rl": bench_rl.N_ACT, "events": bench_events.OUT_DIM,
          "tsf": bench_tsf.HORIZON * bench_tsf.C, "tsc": 2}
STEPS = 3


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


# --------------------------------------------------------------- generators


@pytest.mark.parametrize("seed", [0, 7])
def test_copy_task_iterator_bit_equal(seed):
    j = jsyn.CopyTaskIterator(vocab=20, seq_len=9, batch=3, seed=seed)
    t = tsyn.CopyTaskIterator(vocab=20, seq_len=9, batch=3, seed=seed)
    for _ in range(3):
        a, b = next(j), next(t)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    assert j.state() == t.state()


@pytest.mark.parametrize("seed,key", [(0, 0), (3, 5), (11, 20_001)])
def test_time_series_generator_bit_equal(seed, key):
    j = jsyn.TimeSeriesGenerator(n_channels=5, seed=seed)
    t = tsyn.TimeSeriesGenerator(n_channels=5, seed=seed)
    for a, b in zip(j.sample(3, 40, key=key), t.sample(3, 40, key=key)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,key", [(0, 0), (5, 3), (5, 30_001)])
def test_event_stream_generator_bit_equal(seed, key):
    j = jsyn.EventStreamGenerator(seed=seed)
    t = tsyn.EventStreamGenerator(seed=seed)
    for a, b in zip(j.sample(2, 12, key=key), t.sample(2, 12, key=key)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _batch_pairs():
    """(JAX batch, port batch) pairs of every proxy at two keys."""
    for key in (0, 4):
        yield (jrl._batch(np.random.default_rng(key), 3),
               bench_rl._batch(np.random.default_rng(key), 3))
        gen = (jsyn.EventStreamGenerator(seed=5),
               tsyn.EventStreamGenerator(seed=5))
        yield jev._data(gen[0], 2, key), bench_events._data(gen[1], 2, key)
        gen = (jsyn.TimeSeriesGenerator(n_channels=8, seed=3),
               tsyn.TimeSeriesGenerator(n_channels=8, seed=3))
        yield jtsf._data(gen[0], 2, key), bench_tsf._data(gen[1], 2, key)
        gen = (jsyn.TimeSeriesGenerator(n_channels=4, seed=11),
               tsyn.TimeSeriesGenerator(n_channels=4, seed=11))
        yield jtsc._data(gen[0], 2, key), bench_tsc._data(gen[1], 2, key)


def test_batch_functions_bit_equal():
    n = 0
    for want, got in _batch_pairs():
        assert want.keys() == got.keys()
        for key in want:
            w = np.asarray(want[key])
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w)
        n += 1
    assert n == 8


# ------------------------------------------------- the JAX modules, driven


def _jax_train(cfg, in_dim, out_dim, loss_fn, data_fn, steps, lr=2e-3,
               seed=0):
    """``benchmarks/common.py::train_model``'s loop, also returning each
    step's loss (``test_jax_train_mirror_is_train_model`` holds the two
    equal)."""
    params = jax_init_params(jcommon.backbone_specs(cfg, in_dim, out_dim),
                             jax.random.PRNGKey(seed))
    opt = joptim.adamw(joptim.warmup_cosine(lr, steps // 10, steps))
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, batch, i):
        def total(p):
            return loss_fn(jcommon.backbone_apply(cfg, p, batch["x"]), batch)

        loss, g = jax.value_and_grad(total)(params)
        g, _ = joptim.clip_by_global_norm(g, 1.0)
        params, opt_state = opt.update(g, opt_state, params, i)
        return params, opt_state, loss

    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, data_fn(i), i)
        losses.append(float(loss))
    return params, losses


def _drive_jax(monkeypatch, jmod, mode, train=None, apply=None):
    """Run ``jmod.run()`` for ``mode`` only, with ``train_model`` replaced
    by ``train`` (or by a no-op) and ``backbone_apply`` by ``apply`` when
    given.  Returns {"metric", "rows" {name: derived}, "loss_fn", ...}."""
    rec = {"rows": {}}

    def fake_train(cfg, in_dim, out_dim, loss_fn, data_fn, *, steps=150,
                   lr=2e-3, seed=0):
        rec.update(cfg=cfg, loss_fn=loss_fn, data_fn=data_fn, dims=(in_dim,
                                                                  out_dim))
        if train is None:
            return None, 0.0
        params, rec["losses"] = train(cfg, in_dim, out_dim, loss_fn, data_fn)
        return params, 0.0

    def fake_compare(task, metric_fn, **kw):
        rec["metric"] = metric_fn(mode)[0]

    monkeypatch.setattr(jmod, "train_model", fake_train)
    monkeypatch.setattr(jmod, "compare_modes", fake_compare, raising=False)
    monkeypatch.setattr(jcommon, "compare_modes", fake_compare)
    monkeypatch.setattr(jmod, "emit", lambda name, us, derived:
                        rec["rows"].__setitem__(name, derived),
                        raising=False)
    if apply is not None:
        monkeypatch.setattr(jmod, "backbone_apply", apply)
    jmod.run()
    return rec


def _pred(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("name", ["rl", "events", "tsf", "tsc"])
def test_loss_fns_match_jax(monkeypatch, name):
    """Each proxy's training loss on the same predictions and batch."""
    jmod, tmod = PROXIES[name]
    width = WIDTHS[name]
    rec = _drive_jax(monkeypatch, jmod, "aaren",
                     apply=lambda cfg, p, x: jnp.zeros(x.shape[:2] + (width,)))
    batch = rec["data_fn"](0)
    pred = _pred(1, np.asarray(batch["x"]).shape[:2] + (rec["dims"][1],))
    want = float(rec["loss_fn"](jnp.asarray(pred), batch))
    got = float(tmod.loss_fn(torch.from_numpy(pred), _t(batch)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", ["events", "tsf", "tsc"])
def test_eval_metrics_match_jax(monkeypatch, name):
    """The eval metrics of a fixed prediction: the JAX module's own code
    (its emitted side metrics at their printed precision) against the
    port's metric functions."""
    jmod, tmod = PROXIES[name]
    seen = {}

    def apply(cfg, p, x):
        seen["pred"] = _pred(2, x.shape[:2] + (WIDTHS[name],))
        seen["x"] = np.asarray(x)
        return jnp.asarray(seen["pred"])

    rec = _drive_jax(monkeypatch, jmod, "aaren", apply=apply)
    pred = torch.from_numpy(seen["pred"])
    if name == "events":
        test = _t(bench_events._data(tsyn.EventStreamGenerator(seed=5),
                                     bench_events.TEST_BATCH,
                                     bench_events.TEST_KEY))
        got = bench_events.scores(pred, test["dt_next"], test["mark_next"])
        np.testing.assert_allclose(got["nll"], rec["metric"], rtol=1e-6)
        side = {"events_rmse_aaren": got["rmse"],
                "events_markacc_aaren": got["markacc"]}
    elif name == "tsf":
        test = bench_tsf._data(tsyn.TimeSeriesGenerator(n_channels=8, seed=3),
                               bench_tsf.TEST_BATCH, bench_tsf.TEST_KEY)
        mse, mae = bench_tsf.errors(pred, torch.from_numpy(test["y"]))
        np.testing.assert_allclose(mse, rec["metric"], rtol=1e-6)
        side = {"tsf_mae_aaren": mae}
    else:
        test = bench_tsc._data(tsyn.TimeSeriesGenerator(n_channels=4,
                                                        seed=11),
                               bench_tsc.TEST_BATCH, bench_tsc.TEST_KEY)
        acc = bench_tsc.accuracy(pred, torch.from_numpy(test["y"]))
        assert acc == rec["metric"]
        side = {}
    np.testing.assert_array_equal(seen["x"], test["x"] if name != "events"
                                  else test["x"].numpy())
    for row, value in side.items():
        assert abs(value - float(rec["rows"][row])) <= 5.01e-5, row


def test_online_return_matches_jax(monkeypatch):
    """The RL rollout under one fixed linear policy in both packages."""
    w = _pred(3, (3, bench_rl.N_ACT)) * 4.0
    rec = _drive_jax(monkeypatch, jrl, "aaren",
                     apply=lambda cfg, p, x: x @ jnp.asarray(w))
    monkeypatch.setattr(bench_rl, "backbone_apply",
                        lambda cfg, p, x: x @ torch.from_numpy(w))
    got = bench_rl.online_return(None, {"proj_in": torch.zeros(1)})
    assert got == rec["metric"]


# ------------------------------------------------------ backbone and training


@pytest.mark.parametrize("mode", ["aaren", "softmax"])
def test_backbone_apply_matches_jax(mode):
    cfg = common.bench_cfg(mode)
    jcfg = jcommon.bench_cfg(mode)
    jparams = jax_init_params(jcommon.backbone_specs(jcfg, 5, 7),
                              jax.random.PRNGKey(0))
    params = common.backbone_params_from_jax(_np(jparams), cfg, "cpu")
    assert sorted(params) == sorted(common.backbone_specs(cfg, 5, 7))
    x = _pred(4, (3, 10, 5))
    want = np.asarray(jax.jit(jcommon.backbone_apply, static_argnums=0)(
        jcfg, jparams, jnp.asarray(x)))
    got = common.backbone_apply(cfg, params, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_jax_train_mirror_is_train_model():
    """``_jax_train`` gives the parameters of the JAX package's
    ``train_model`` itself."""
    cfg = jcommon.bench_cfg("softmax")
    gen = jsyn.TimeSeriesGenerator(n_channels=4, seed=11)

    def loss_fn(pred, batch):
        return jnp.mean((pred[:, -1, 0] - batch["y"]) ** 2)

    def data_fn(i):
        return jtsc._data(gen, 4, i)

    want, _ = jcommon.train_model(cfg, 4, 2, loss_fn, data_fn, steps=STEPS)
    got, _ = _jax_train(cfg, 4, 2, loss_fn, data_fn, STEPS)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
