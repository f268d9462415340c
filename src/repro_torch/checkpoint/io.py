"""Atomic, async checkpointing with resilient restore — port of
``repro.checkpoint.io``, writing the same manifest format (``format: 1``).

Layout (one directory per step)::

    <dir>/step_000001230/
        manifest.json            # leaf paths, shapes, dtypes, chunks, crcs
        leaf_00000_00000000.npy ...
    <dir>/LATEST                 # atomic pointer file (write tmp + rename)

A checkpoint crosses between the packages in both directions, bit for bit:

* **Same leaf paths.**  A tree flattens as the JAX package's
  ``tree_flatten_with_path`` does: a NamedTuple field as ``.name``, a dict
  key (in sorted order) as the key, a list or tuple index as the index,
  ``None`` as no leaf.  A ``TrainState`` gives ``.step``,
  ``.params/...``, ``.opt_state/...`` and ``.guard/.lr_scale``.
* **The step is a leaf.**  Python ints and floats are stored as the 0-d
  int32 and f32 arrays JAX holds, and come back as Python numbers.
* **Same bytes for bf16.**  The raw bits are written as a uint8 view with
  dtype string ``"bfloat16"``.

The rest is the JAX package's design:

* **Atomicity** — a step directory is staged as ``.tmp-step_*`` and renamed
  only after every chunk + manifest is fsync'd; ``LATEST`` is updated last.
* **Self-validation, manifest last** — every chunk carries a crc32 and the
  manifest (which alone makes a step directory *valid*) is written after
  all of them; restore verifies crc, chunk presence, and row coverage.
* **Resilient restore** — ``step=None`` walks checkpoints newest-first and
  falls back past any corrupt/truncated step to the newest intact one.  An
  explicitly requested step never falls back.
* **Bounded chunks** — leaves are split along axis 0 at ``chunk_mb``.
* **Structure errors name paths**; ``strict=False`` is a partial (warm
  start) restore.
* **Async** — ``Checkpointer.save_async`` copies the tree to host memory
  synchronously (a copy: the next in-place optimizer step must not rewrite
  it), then writes in a background thread; a failed write surfaces on the
  next ``wait()`` / ``save_async()``.

Restore copies each leaf into the template's own tensors, one leaf at a
time, so restoring a full-width training state needs no second device
copy of it.  Placing leaves on a mesh (``shardings=``) comes with the
multi-device layers (ROADMAP queue A item 11).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

class CheckpointCorruptionError(IOError):
    """A checkpoint step directory failed validation (crc, truncation,
    missing chunk/manifest)."""


class CheckpointStructureError(ValueError):
    """The checkpoint's leaf set does not match the restore template."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_tree(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves, in the JAX package's flatten
    order (dict keys sorted); containers keep their types (NamedTuples,
    tuples, lists, dicts in their own key order)."""
    def sub(name, child):
        return _map_tree(fn, child, f"{prefix}/{name}" if prefix else name)

    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(sub(f".{f}", getattr(tree, f))
                            for f in tree._fields))
    if isinstance(tree, dict):
        out = {k: sub(str(k), tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub(str(i), x) for i, x in enumerate(tree))
    return fn(prefix, tree)


def _flatten_with_paths(tree):
    """(paths, leaves) of ``tree``, paths as the JAX package writes them."""
    paths, leaves = [], []

    def visit(path, leaf):
        paths.append(path)
        leaves.append(leaf)

    _map_tree(visit, tree)
    return paths, leaves


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array and its manifest dtype string; bf16 as its
    int16 bits.  A CPU tensor's array shares its storage."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy(), "bfloat16"
        arr = t.cpu().numpy()
        return arr, str(arr.dtype)
    if isinstance(leaf, bool):
        arr = np.asarray(leaf)
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    elif isinstance(leaf, float):
        arr = np.asarray(leaf, np.float32)
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.int16), "bfloat16"
    return arr, str(arr.dtype)


def _snapshot_leaf(leaf):
    """A host copy that later in-place writes to ``leaf`` cannot reach."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    extra: dict | None = None, chunk_mb: int = 512,
                    keep: int = 3) -> str:
    """Synchronous atomic save.  Returns the final step directory."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:012d}"
    tmp = os.path.join(directory, f".tmp-{name}")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        _write_step(tmp, step, tree, extra=extra, chunk_mb=chunk_mb)
    except BaseException:
        # Never leave a half-written tmp dir to be mistaken for progress;
        # the previous step_* directories are untouched either way.
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    # atomic LATEST pointer
    ptr_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))

    _gc_old(directory, keep)
    return final


def _write_step(tmp: str, step: int, tree: Any, *, extra: dict | None,
                chunk_mb: int):
    """Write chunks then manifest (last — it is what makes the dir valid)."""
    paths, leaves = _flatten_with_paths(tree)
    manifest: dict[str, Any] = {
        "format": 1,
        "step": step,
        "extra": extra or {},
        "leaves": [],
    }
    chunk_bytes = max(chunk_mb * (1 << 20), 1)
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        arr, dtype_str = _host_array(leaf)
        n_chunks = max(1, -(-arr.nbytes // chunk_bytes))
        rows = arr.shape[0] if arr.ndim else 1
        per = max(1, -(-rows // n_chunks))
        chunks = []
        flat_view = arr.reshape((rows, -1)) if arr.ndim else arr.reshape(1, 1)
        for c in range(0, rows, per):
            piece = np.ascontiguousarray(flat_view[c:c + per])
            fname = f"leaf_{i:05d}_{c:08d}.npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, piece.view(np.uint8) if dtype_str == "bfloat16"
                        else piece)
                f.flush()
                os.fsync(f.fileno())
            chunks.append({"file": fname, "rows": [c, min(c + per, rows)],
                           "crc32": zlib.crc32(piece)})
        manifest["leaves"].append({
            "path": path, "shape": list(arr.shape), "dtype": dtype_str,
            "chunks": chunks})

    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())


def _gc_old(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def available_steps(directory: str) -> list[int]:
    """All step numbers with a (renamed, i.e. fully written) directory,
    ascending.  ``.tmp-*`` staging dirs from a killed save are ignored."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and os.path.isdir(
                os.path.join(directory, d)):
            try:
                out.append(int(d.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return sorted(out)


def latest_step(directory: str) -> int | None:
    """Newest step per the LATEST pointer, falling back to a directory scan
    when the pointer is missing or dangling (e.g. killed between the step
    rename and the pointer update)."""
    ptr = os.path.join(directory, "LATEST")
    if os.path.exists(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        if os.path.isdir(os.path.join(directory, name)):
            return int(name.split("_")[1])
    steps = available_steps(directory)
    return steps[-1] if steps else None


def _read_manifest(src: str) -> dict:
    mpath = os.path.join(src, "manifest.json")
    if not os.path.exists(mpath):
        raise CheckpointCorruptionError(
            f"{src}: no manifest.json (save killed before the manifest "
            "write — the directory is invalid)")
    try:
        with open(mpath) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptionError(
            f"{src}: unreadable manifest.json ({e})") from e


def _load_flat(src: str, rec: dict) -> np.ndarray:
    """One leaf's chunks, crc-checked, as a (rows, cols) host array in the
    stored dtype (uint8 bytes for bf16)."""
    shape = tuple(rec["shape"])
    rows = shape[0] if shape else 1
    flat = None
    covered = 0
    for chunk in rec["chunks"]:
        fpath = os.path.join(src, chunk["file"])
        try:
            piece = np.load(fpath)
        except FileNotFoundError as e:
            raise CheckpointCorruptionError(
                f"{src}: missing chunk {chunk['file']} "
                f"for leaf {rec['path']!r}") from e
        except (ValueError, EOFError, OSError) as e:
            raise CheckpointCorruptionError(
                f"{src}: truncated/corrupt chunk {chunk['file']} "
                f"for leaf {rec['path']!r} ({e})") from e
        lo, hi = chunk["rows"]
        if piece.ndim != 2 or piece.shape[0] != hi - lo:
            raise CheckpointCorruptionError(
                f"{src}: chunk {chunk['file']} has shape {piece.shape}, "
                f"manifest says rows [{lo}, {hi})")
        if zlib.crc32(np.ascontiguousarray(piece)) != chunk["crc32"]:
            raise CheckpointCorruptionError(
                f"{src}: crc mismatch in {chunk['file']} "
                f"for leaf {rec['path']!r}")
        if flat is None:
            flat = np.empty((rows, piece.shape[1]), piece.dtype)
        flat[lo:hi] = piece
        covered += hi - lo
    if flat is None or covered != rows:
        raise CheckpointCorruptionError(
            f"{src}: leaf {rec['path']!r} chunks cover {covered}/{rows} rows")
    return flat


def _as_tensor(flat: np.ndarray, rec: dict) -> torch.Tensor:
    shape = tuple(rec["shape"])
    t = torch.from_numpy(flat)
    if rec["dtype"] == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.reshape(shape)


def _dtype_name(like) -> str:
    if torch.is_tensor(like):
        return ("bfloat16" if like.dtype == torch.bfloat16
                else str(like.dtype).removeprefix("torch."))
    return _host_array(like)[1]


def _shape(like) -> tuple:
    if torch.is_tensor(like):
        return tuple(like.shape)
    return tuple(np.shape(like))


@torch.no_grad()
def _into(like, flat: np.ndarray, rec: dict):
    """The restored value of one leaf: copied into ``like`` when it is a
    tensor (which is returned), else a value of ``like``'s kind."""
    if torch.is_tensor(like):
        like.copy_(_as_tensor(flat, rec))
        return like
    shape = tuple(rec["shape"])
    if isinstance(like, (bool, int, float)):
        return type(like)(flat.reshape(shape).item())
    if rec["dtype"] == "bfloat16":
        return flat.view(np.asarray(like).dtype).reshape(shape)
    return flat.reshape(shape).copy()


def verify_checkpoint(directory: str, step: int) -> dict:
    """Validate one step end to end (manifest, chunk files, crcs).  Returns
    the manifest; raises :class:`CheckpointCorruptionError` on any defect."""
    src = os.path.join(directory, f"step_{step:012d}")
    if not os.path.isdir(src):
        raise CheckpointCorruptionError(f"{src}: no such checkpoint")
    manifest = _read_manifest(src)
    for rec in manifest["leaves"]:
        _load_flat(src, rec)
    return manifest


def read_checkpoint_extra(directory: str, step: int) -> dict:
    """Read one step's manifest ``extra`` dict without restoring any leaves.

    For callers whose restore template depends on what was saved.  Raises
    :class:`CheckpointCorruptionError` on a missing/unreadable manifest;
    :func:`restore_checkpoint` still verifies every chunk.
    """
    src = os.path.join(directory, f"step_{step:012d}")
    if not os.path.isdir(src):
        raise CheckpointCorruptionError(f"{src}: no such checkpoint")
    return _read_manifest(src).get("extra", {})


def _restore_step(src: str, tree_like: Any, *, strict: bool):
    manifest = _read_manifest(src)
    paths, like_leaves = _flatten_with_paths(tree_like)
    by_path = {rec["path"]: rec for rec in manifest["leaves"]}
    missing = [p for p in paths if p not in by_path]
    extra_leaves = [p for p in by_path if p not in set(paths)]
    if strict and (missing or extra_leaves):
        raise CheckpointStructureError(
            f"{src}: checkpoint tree does not match the restore template.\n"
            f"  missing from checkpoint: {missing or '—'}\n"
            f"  only in checkpoint:      {extra_leaves or '—'}\n"
            "Pass strict=False for a partial (warm-start) restore.")
    # Shapes and dtypes before any copy: a mismatch leaves the template as
    # it was.
    for path, like in zip(paths, like_leaves):
        rec = by_path.get(path)
        if rec is None:
            continue
        if (tuple(rec["shape"]) != _shape(like)
                or rec["dtype"] != _dtype_name(like)):
            raise CheckpointStructureError(
                f"{src}: leaf {path!r} is {rec['dtype']}{rec['shape']} in "
                f"the checkpoint and {_dtype_name(like)}"
                f"{list(_shape(like))} in the template")
    if not strict:
        # A partial restore must not leave a leaf copied from a step that
        # then fails: the next candidate may not hold that leaf.
        for path in paths:
            if path in by_path:
                _load_flat(src, by_path[path])
    restored = {}
    for path, like in zip(paths, like_leaves):
        rec = by_path.get(path)
        # strict=False: a leaf absent from the checkpoint keeps its value
        restored[path] = like if rec is None else _into(
            like, _load_flat(src, rec), rec)
    tree = _map_tree(lambda path, _: restored[path], tree_like)
    return tree, manifest["step"], manifest.get("extra", {})


def restore_checkpoint(directory: str, tree_like: Any, step: int | None = None,
                       *, shardings: Any = None, strict: bool = True):
    """Restore into ``tree_like``: each tensor leaf is overwritten in place
    with the saved values (same shape and dtype, or
    :class:`CheckpointStructureError`); Python numbers and numpy leaves
    come back as new values of their kind.

    ``step=None`` restores the newest *intact* step: corrupt or truncated
    candidates are skipped newest-first and reported only if nothing
    survives (the template's tensors may then hold a mix of candidates).
    An explicit ``step`` is restored exactly or raises.  With
    ``strict=False`` leaves absent from the checkpoint keep the template's
    values.  Returns (tree, step, extra).
    """
    if shardings is not None:
        raise NotImplementedError(
            "restore_checkpoint(shardings=...) comes with the port's "
            "multi-device layers (ROADMAP queue A item 11)")
    if step is not None:
        return _restore_step(
            os.path.join(directory, f"step_{step:012d}"), tree_like,
            strict=strict)

    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    # LATEST-pointed step first (it is the newest *committed* one), then the
    # directory scan newest-first for the fallback walk.
    ptr = latest_step(directory)
    candidates = sorted(set(steps), reverse=True)
    if ptr in candidates:
        candidates.remove(ptr)
        candidates.insert(0, ptr)
    failures: list[str] = []
    for s in candidates:
        src = os.path.join(directory, f"step_{s:012d}")
        try:
            return _restore_step(src, tree_like, strict=strict)
        except CheckpointCorruptionError as e:
            failures.append(str(e))
    raise CheckpointCorruptionError(
        "no intact checkpoint under {}; every candidate failed:\n  {}".format(
            directory, "\n  ".join(failures)))


class Checkpointer:
    """Async wrapper: snapshot synchronously, write in the background."""

    def __init__(self, directory: str, *, keep: int = 3, chunk_mb: int = 512):
        self.directory = directory
        self.keep = keep
        self.chunk_mb = chunk_mb
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any, *, extra: dict | None = None):
        self.wait()  # one in-flight save at a time; surfaces a prior failure
        host_tree = _map_tree(lambda _, x: _snapshot_leaf(x), tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra=extra,
                                chunk_mb=self.chunk_mb, keep=self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, step: int, tree: Any, *, extra: dict | None = None):
        self.wait()
        save_checkpoint(self.directory, step, tree, extra=extra,
                        chunk_mb=self.chunk_mb, keep=self.keep)
