"""The port's checkpoints (``repro_torch.checkpoint``) — the cases of
``tests/test_checkpoint.py`` — and checkpoints crossing between the
packages: the same manifest (format 1), the same leaf paths, the same
bytes, bf16 included, read back bit for bit in both directions.
"""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.checkpoint.io as ckpt_io
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.checkpoint import verify_checkpoint as jax_verify
from repro.checkpoint.io import _flatten_with_paths as jax_paths
from repro.train.guard import GuardConfig as JaxGuardConfig
from repro.train.optim import make_optimizer as jax_make_optimizer
from repro.train.optim import warmup_cosine as jax_warmup_cosine
from repro.train.state import init_train_state as jax_init_train_state
from repro_torch.checkpoint import (
    Checkpointer,
    CheckpointCorruptionError,
    CheckpointStructureError,
    available_steps,
    latest_step,
    read_checkpoint_extra,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)
from repro_torch.train.guard import GuardConfig
from repro_torch.train.optim import make_optimizer, warmup_cosine
from repro_torch.train.state import init_train_state
from repro_torch.tree import tree_leaves


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(16, 8, generator=g),
        "nested": {"b": torch.arange(5, dtype=torch.int32),
                   "scalar": torch.tensor(3.5)},
        "bf16": torch.randn(4, 4, generator=g).to(torch.bfloat16),
    }


def _zeros_like(tree):
    return ckpt_io._map_tree(lambda _, t: torch.zeros_like(t), tree)


def _bits(t):
    """Tensor or array -> numpy array of its raw bits (bf16 as int16)."""
    if torch.is_tensor(t):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_bit_equal(got, want):
    paths, g_leaves = ckpt_io._flatten_with_paths(got)
    _, w_leaves = ckpt_io._flatten_with_paths(want)
    for p, a, b in zip(paths, g_leaves, w_leaves):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=p)


# ---------------------------------------------------------------------------
# The JAX suite's cases
# ---------------------------------------------------------------------------


def test_roundtrip_restores_into_the_template():
    tree = _tree()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 7, tree, extra={"data": {"count": 3}})
        assert latest_step(d) == 7
        like = _zeros_like(tree)
        out, step, extra = restore_checkpoint(d, like)
        assert step == 7 and extra == {"data": {"count": 3}}
        _assert_bit_equal(out, tree)
        assert out["w"] is like["w"]          # copied in place


def test_chunked_large_leaf():
    tree = {"big": torch.randn(1024, 64)}
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, 1, tree, chunk_mb=0)  # one row a chunk
        assert len([f for f in os.listdir(path)
                    if f.startswith("leaf_")]) == 1024
        out, _, _ = restore_checkpoint(d, _zeros_like(tree))
        assert torch.equal(out["big"], tree["big"])


def test_keep_gc():
    tree = {"x": torch.zeros(3)}
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(d, s, tree, keep=2)
        assert available_steps(d) == [4, 5] and latest_step(d) == 5


def test_crc_detects_corruption():
    tree = {"x": torch.randn(64, 4)}
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, 1, tree)
        chunk = next(f for f in os.listdir(path) if f.startswith("leaf_"))
        fp = os.path.join(path, chunk)
        data = bytearray(open(fp, "rb").read())
        data[-2] ^= 0xFF  # flip a payload byte
        open(fp, "wb").write(bytes(data))
        with pytest.raises(IOError, match="crc"):
            restore_checkpoint(d, _zeros_like(tree))


def test_async_snapshot_survives_the_next_in_place_step():
    """save_async copies the tree to host memory before it returns: an
    in-place optimizer step right after it (CPU tensors, whose numpy views
    would share storage) does not reach the checkpoint."""
    params = {"w": torch.randn(32, 8), "b": torch.randn(8)}
    opt = make_optimizer("adamw", warmup_cosine(1e-1, 0, 10))
    state = init_train_state(params, opt)
    want = [t.clone() for t in tree_leaves((state.params, state.opt_state))]
    grads = {"w": torch.ones(32, 8), "b": torch.ones(8)}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save_async(0, state)
        opt.update(grads, state.opt_state, state.params, 0)   # in place
        ck.wait()
        assert not torch.equal(state.params["w"], want[0])
        fresh = init_train_state({"w": torch.zeros(32, 8),
                                  "b": torch.zeros(8)}, opt)
        out, step, _ = restore_checkpoint(d, fresh)
        assert step == 0 and out.step == 0
        for a, b in zip(tree_leaves((out.params, out.opt_state)), want):
            assert torch.equal(a, b)


def test_save_killed_before_manifest_leaves_no_valid_step(monkeypatch):
    tree = _tree()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree)

        def boom(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(ckpt_io.json, "dump", boom)
        with pytest.raises(OSError, match="disk full"):
            save_checkpoint(d, 2, tree)
        monkeypatch.undo()
        assert available_steps(d) == [1]
        assert not [x for x in os.listdir(d) if x.startswith(".tmp")]
        _, step, _ = restore_checkpoint(d, _zeros_like(tree))
        assert step == 1


def test_save_killed_mid_chunk_keeps_older_steps(monkeypatch):
    tree = _tree()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree)
        real_save = ckpt_io.np.save
        calls = {"n": 0}

        def flaky(f, arr, **k):
            calls["n"] += 1
            if calls["n"] == 2:
                raise OSError("torn write")
            return real_save(f, arr, **k)

        monkeypatch.setattr(ckpt_io.np, "save", flaky)
        with pytest.raises(OSError, match="torn write"):
            save_checkpoint(d, 2, tree)
        monkeypatch.undo()
        assert available_steps(d) == [1]
        verify_checkpoint(d, 1)


def test_checkpointer_write_failure_surfaces_on_wait(monkeypatch):
    tree = _tree()
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        ck.save_async(1, tree)
        ck.wait()

        def boom(*a, **k):
            raise OSError("backend gone")

        monkeypatch.setattr(ckpt_io.np, "save", boom)
        ck.save_async(2, tree)
        with pytest.raises(OSError, match="backend gone"):
            ck.wait()
        monkeypatch.undo()
        assert available_steps(d) == [1] and latest_step(d) == 1
        verify_checkpoint(d, 1)
        ck.save_async(3, tree)
        ck.wait()
        assert latest_step(d) == 3


def test_latest_pointer_dangling_falls_back_to_scan():
    tree = {"x": torch.zeros(3)}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 4, tree)
        with open(os.path.join(d, "LATEST"), "w") as f:
            f.write("step_000000000009")
        assert latest_step(d) == 4
        _, step, _ = restore_checkpoint(d, tree)
        assert step == 4


def test_structure_mismatch_names_offending_paths():
    tree = {"w": torch.randn(4, 4), "old_head": torch.zeros(3)}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree)
        template = {"w": torch.zeros(4, 4), "new_head": torch.ones(5)}
        with pytest.raises(CheckpointStructureError) as ei:
            restore_checkpoint(d, template)
        msg = str(ei.value)
        assert "new_head" in msg and "old_head" in msg
        assert "strict=False" in msg
        assert torch.equal(template["w"], torch.zeros(4, 4))


def test_shape_or_dtype_mismatch_names_the_leaf_and_copies_nothing():
    tree = {"a": torch.randn(3), "w": torch.randn(4, 4)}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree)
        for bad in ({"a": torch.zeros(3), "w": torch.zeros(4, 5)},
                    {"a": torch.zeros(3), "w": torch.zeros(4, 4,
                                                           dtype=torch.bfloat16)}):
            with pytest.raises(CheckpointStructureError, match="'w'"):
                restore_checkpoint(d, bad)
            assert torch.equal(bad["a"], torch.zeros(3))


def test_partial_restore_warm_start():
    tree = {"w": torch.randn(4, 4), "old_head": torch.zeros(3)}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree)
        template = {"w": torch.zeros(4, 4), "new_head": torch.full((5,), 7.)}
        out, step, _ = restore_checkpoint(d, template, strict=False)
        assert step == 1
        assert torch.equal(out["w"], tree["w"])
        assert torch.equal(out["new_head"], torch.full((5,), 7.0))


def test_shardings_wait_for_the_multi_device_layers():
    tree = {"w": torch.randn(4, 4)}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree)
        with pytest.raises(NotImplementedError, match="item 11"):
            restore_checkpoint(d, tree, shardings={"w": None})


def test_verify_checkpoint_detects_truncation():
    tree = {"x": torch.randn(64, 4)}
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, 1, tree)
        verify_checkpoint(d, 1)
        chunk = next(f for f in os.listdir(path) if f.startswith("leaf_"))
        fp = os.path.join(path, chunk)
        with open(fp, "r+b") as f:
            f.truncate(os.path.getsize(fp) // 2)
        with pytest.raises(CheckpointCorruptionError):
            verify_checkpoint(d, 1)


def test_manifest_extra_roundtrips_json_types():
    tree = {"x": torch.zeros(2)}
    extra = {"engine": {"queue": [[1, [3, 4], 2, None]],
                        "errors": {"7": "deadline exceeded"}}}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree, extra=extra)
        assert read_checkpoint_extra(d, 1) == extra
        _, _, got = restore_checkpoint(d, tree)
        assert got == extra


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


def _mixed_np(seed=0):
    """bf16, f32 and int32 leaves, 0-d leaves, and a leaf long enough to
    chunk, as numpy (bf16 as ml_dtypes' bfloat16)."""
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((64, 8)).astype(np.float32),
        "bf16": rng.standard_normal((16, 6)).astype(jnp.bfloat16),
        "i32": rng.integers(-5, 5, (7,)).astype(np.int32),
        "scalars": {"f": np.float32(2.5), "i": np.int32(-3),
                    "bf": np.asarray(1.5, jnp.bfloat16)},
        "list": [rng.standard_normal((3, 2, 2)).astype(np.float32),
                 rng.integers(0, 9, (2, 2)).astype(np.int32)],
    }


def _torch_of(np_tree):
    def one(_, a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    return ckpt_io._map_tree(one, np_tree)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:012d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("chunk_mb", [0, 512], ids=["row_chunks", "whole"])
def test_jax_checkpoint_restores_into_the_port_bit_for_bit(chunk_mb):
    tree = _mixed_np()
    with tempfile.TemporaryDirectory() as d:
        jax_save(d, 5, jax.tree.map(jnp.asarray, tree), chunk_mb=chunk_mb,
                 extra={"data": {"count": 5}})
        out, step, extra = restore_checkpoint(
            d, _zeros_like(_torch_of(tree)))
        assert step == 5 and extra == {"data": {"count": 5}}
        _assert_bit_equal(out, _torch_of(tree))
        verify_checkpoint(d, 5)


@pytest.mark.parametrize("chunk_mb", [0, 512], ids=["row_chunks", "whole"])
def test_port_checkpoint_restores_into_jax_bit_for_bit(chunk_mb):
    tree = _mixed_np(1)
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as dj:
        save_checkpoint(d, 5, _torch_of(tree), chunk_mb=chunk_mb)
        jax_verify(d, 5)
        like = jax.tree.map(lambda a: jnp.zeros_like(jnp.asarray(a)), tree)
        out, step, _ = jax_restore(d, like)
        assert step == 5
        for p, a, b in zip(jax_paths(out)[0], jax.tree.leaves(out),
                           jax.tree.leaves(tree)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, p
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=p)
        # The same tree written by JAX gives the same manifest: paths,
        # dtypes, chunking and crcs.
        jax_save(dj, 5, jax.tree.map(jnp.asarray, tree), chunk_mb=chunk_mb)
        assert _manifest(d, 5) == _manifest(dj, 5)


def test_leaf_paths_equal_jax_for_a_guarded_train_state():
    """A TrainState (step, params, AdamW moments, GuardState) flattens to
    the same leaf paths in the same order in both packages, and a port
    state round-trips with its step as the int32 leaf ``.step``."""
    np_params = {"embed": {"table": np.ones((4, 3), np.float32)},
                 "layers": [{"w": np.ones((3, 3), np.float32),
                             "b": np.zeros(3, np.float32)}]}
    jopt = jax_make_optimizer("adamw", jax_warmup_cosine(1e-3, 1, 4))
    jstate = jax_init_train_state(jax.tree.map(jnp.asarray, np_params), jopt,
                                  guard=JaxGuardConfig())
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 1, 4))
    state = init_train_state(_torch_of(np_params), opt, guard=GuardConfig())
    paths = ckpt_io._flatten_with_paths(state)[0]
    assert paths == jax_paths(jstate)[0]
    assert paths[0] == ".step" and ".guard/.lr_scale" in paths
    assert ".params/layers/0/w" in paths and ".opt_state/m/embed/table" in paths

    state = state._replace(step=3)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 3, state)
        rec = _manifest(d, 3)["leaves"][0]
        assert (rec["path"], rec["dtype"], rec["shape"]) == (
            ".step", "int32", [])
        fresh = init_train_state(_zeros_like(_torch_of(np_params)), opt,
                                 guard=GuardConfig())
        out, step, _ = restore_checkpoint(d, fresh)
        assert step == 3 and out.step == 3 and isinstance(out.step, int)
        _assert_bit_equal(out, state)
        # and JAX reads the port's train state
        jout, jstep, _ = jax_restore(d, jstate)
        assert jstep == 3 and int(jout.step) == 3
        assert float(jout.guard.lr_scale) == 1.0
