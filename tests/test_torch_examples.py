"""The port's examples (``examples/torch``) on the CPU at small sizes, and
the card default of its entry points: with no card they raise instead of
running on the CPU."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from examples.torch import chunked_prefill, quickstart  # noqa: E402
from examples.torch import streaming_inference, train_lm  # noqa: E402
from repro_torch.core import softmax_attention as soft  # noqa: E402


def test_quickstart_loss_drops(capsys):
    out = quickstart.main(["--device", "cpu", "--steps", "30"])
    assert out["last_loss"] < out["first_loss"]
    assert len(out["generated"]) == 8
    printed = capsys.readouterr().out
    for line in printed.splitlines()[:2]:  # the three ways agree
        assert float(line.split(":")[1]) < 1e-5


def test_chunked_prefill_matches_one_shot():
    assert chunked_prefill.main(["--device", "cpu", "--prompt", "70",
                                 "--chunk", "16", "--new", "4"])


def test_streaming_inference_finishes():
    out = streaming_inference.main(["--device", "cpu", "--requests", "4",
                                    "--new", "5"])
    assert out["finished"] == 4
    assert out["state_kv"] > out["state_aaren"]


@pytest.mark.parametrize("pack", [False, True])
def test_train_lm_small_both_mixers(pack):
    argv = ["--device", "cpu", "--small", "--steps", "3", "--batch", "4",
            "--seq-len", "32"] + (["--pack"] if pack else [])
    hists = train_lm.main(argv)
    assert sorted(hists) == ["aaren", "softmax"]
    for hist in hists.values():
        assert [s for s, _ in hist] == [0, 1, 2]
        assert all(torch.isfinite(torch.tensor(m["loss"])) for _, m in hist)
        assert all(("token_util" in m) == pack for _, m in hist)


@pytest.mark.parametrize("flag", ["--context-parallel", "--model-parallel",
                                  "--fsdp"])
def test_train_lm_refuses_mesh_flags(flag):
    with pytest.raises(NotImplementedError, match="item 11"):
        train_lm.main(["--device", "cpu", "--small", flag, "2"])


def test_entry_points_default_to_the_card(monkeypatch):
    """No device given: the examples and ``init_kv_cache`` (which defaulted
    to the CPU before) go to the card, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soft.init_kv_cache(1, 4, 1, 8)
    for mod in (quickstart, chunked_prefill, streaming_inference, train_lm):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])
    cache = soft.init_kv_cache(1, 4, 1, 8, device="cpu")
    assert cache["k"].device.type == "cpu"
