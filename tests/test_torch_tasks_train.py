"""Three training steps of each paper-table proxy, both mixers, on the
port (``benchmarks/torch``) and the JAX package (``benchmarks/bench_*.py``,
driven through its ``run`` by ``tests/test_torch_tasks.py``'s helpers),
from the same initial weights, on the CPU.

Bars: per-step training loss rtol 1e-5; then each proxy's eval metric,
continuous ones at rtol 1e-4, accuracy and the RL return (over 4 rollouts,
not 16) exactly.
"""

import functools
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
for path in (REPO, REPO / "tests"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from benchmarks import bench_rl as jrl  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from benchmarks.torch import bench_rl, common  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from test_torch_tasks import PROXIES, STEPS, _drive_jax, _jax_train, _np  # noqa: E402

EPISODES = 4  # RL rollouts after the three steps (the proxy runs 16)


@pytest.mark.parametrize("mode", ["aaren", "softmax"])
@pytest.mark.parametrize("name", ["rl", "events", "tsf", "tsc"])
def test_three_steps_then_metric_match_jax(monkeypatch, name, mode):
    """Three ``train_model`` steps from the JAX initial weights: the same
    per-step losses, then the same eval metric."""
    jmod, tmod = PROXIES[name]

    def train(cfg, in_dim, out_dim, loss_fn, data_fn):
        params, losses = _jax_train(cfg, in_dim, out_dim, loss_fn, data_fn,
                                    STEPS)
        init = jax_init_params(jcommon.backbone_specs(cfg, in_dim, out_dim),
                               jax.random.PRNGKey(0))
        rec_init["params"] = _np(init)
        return params, losses

    rec_init = {}
    # One compiled forward per shape, in place of eager JAX; the rollout
    # cut to EPISODES episodes in both packages.
    monkeypatch.setattr(jmod, "backbone_apply",
                        jax.jit(jcommon.backbone_apply, static_argnums=0))
    if name == "rl":
        monkeypatch.setattr(jrl, "_online_return", functools.partial(
            jrl._online_return, episodes=EPISODES))
        monkeypatch.setattr(bench_rl, "online_return", functools.partial(
            bench_rl.online_return, episodes=EPISODES))
    rec = _drive_jax(monkeypatch, jmod, mode, train=train)
    cfg = common.bench_cfg(mode)
    params = common.backbone_params_from_jax(rec_init["params"], cfg, "cpu")
    got = tmod.metric(mode, device="cpu", steps=STEPS, params=params)
    np.testing.assert_allclose(got["losses"], rec["losses"], rtol=1e-5)
    if name in ("rl", "tsc"):
        assert got["metric"] == rec["metric"]
    else:
        np.testing.assert_allclose(got["metric"], rec["metric"], rtol=1e-4)
