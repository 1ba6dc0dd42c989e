"""Checkpointing: atomic, async, keep-k, incremental (PyTorch counterpart of
``repro/runtime/checkpoint.py``, on the same on-disk layout, so each package
reads the other's directories).

Layout (one directory per step):
    <dir>/step_000123/
        MANIFEST.json     — tree structure, save kind (full/delta), base step
        <leaf-path>.npy   — one file per *written* leaf (path joined by ``__``)
    <dir>/step_000123.tmp — staging dir, atomically renamed on completion

A tree is nested dicts, lists and tuples whose leaves are torch tensors (on
any device), numpy arrays or Python scalars.  Saving walks it once and turns
every tensor into a host numpy array that owns its bytes (``_host_tree``):
a tensor on the card is copied to the host after the work queued on the
current stream, and a CPU tensor is copied, because the caller may keep
writing its buffer while the writer thread serializes.

Fault-tolerance properties:
  * atomic publish: readers never observe a partial checkpoint (rename(2));
  * async: ``save_async`` copies to the host now, then writes on a
    background thread so the caller keeps stepping;
  * keep-k garbage collection (delta-chain aware: a kept step's base chain
    is never collected out from under it);
  * ``latest_step`` skips unpublished (crashed mid-write) checkpoints, so
    restart after a mid-save failure falls back to the previous good step.

Incremental saves (``full_every > 1``): a *delta* save writes only the
leaves whose bytes changed since the last published step (blake2b per
leaf) and records that step as its base; every ``full_every``-th save (and
the first of a process, and any step-number rewind) is full.  ``restore``
composes base+delta by walking the chain.  The unit of a delta is a leaf: a
fleet's P is one leaf, so any stream that learned rewrites all of it.

``restore`` returns numpy leaves, or, with ``shardings``, puts each leaf on
the device named for it, or cuts it into the slices a
``sharding.Placement`` names, each on its mesh entry: checkpoints hold
whole logical arrays, so the same bytes restore onto any device layout.
``rescale`` restores a model's params onto a mesh of another size by the
schema's ``param_specs``; a fleet saved from N shards is split into M by
``engine.split_fleet`` after the restore.  A ``sharding.Sharded`` leaf is
saved whole (``Sharded.gather``); ``restore_train_state`` lays a saved
``TrainState`` out on a mesh for the partitioned training step.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.distributed import sharding


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),))
    else:
        yield path, tree


def _unflatten(leaves: dict, manifest):
    if manifest["kind"] == "leaf":
        return leaves[manifest["path"]]
    if manifest["kind"] == "dict":
        return {k: _unflatten(leaves, v) for k, v in manifest["children"].items()}
    seq = [_unflatten(leaves, v) for v in manifest["children"]]
    return tuple(seq) if manifest["kind"] == "tuple" else seq


def _manifest_of(tree, path=()):
    if isinstance(tree, dict):
        return {
            "kind": "dict",
            "children": {k: _manifest_of(tree[k], path + (str(k),)) for k in sorted(tree)},
        }
    if isinstance(tree, (list, tuple)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return {
            "kind": kind,
            "children": [_manifest_of(v, path + (str(i),)) for i, v in enumerate(tree)],
        }
    return {"kind": "leaf", "path": "/".join(path)}


def _leaf_paths(manifest):
    if manifest["kind"] == "leaf":
        yield manifest["path"]
    elif manifest["kind"] == "dict":
        for v in manifest["children"].values():
            yield from _leaf_paths(v)
    else:
        for v in manifest["children"]:
            yield from _leaf_paths(v)


def _digest(arr: np.ndarray) -> str:
    # dtype+shape fold in so a reshape/retype with identical bytes still
    # counts as changed (the .npy on disk would differ).
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((arr.dtype.str, arr.shape)).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def to_host(leaf) -> np.ndarray:
    """One leaf as a host numpy array.  A tensor becomes an array that owns
    its bytes: on the card ``.cpu()`` copies into fresh host memory once the
    current stream's queued work has written them; on the CPU the tensor's
    buffer is copied (``.numpy()`` alone would alias it).  Anything else
    goes through ``np.asarray``; a ``Sharded`` leaf is gathered whole
    first."""
    if isinstance(leaf, sharding.Sharded):
        leaf = leaf.gather()
    if torch.is_tensor(leaf):
        leaf = leaf.detach()
        if leaf.device.type == "cpu":
            return leaf.numpy().copy()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _host_tree(tree):
    """The tree with every leaf through ``to_host`` (containers rebuilt as
    plain dicts, lists and tuples: the manifest records no other kind)."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host_tree(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_host_tree(v) for v in tree)
    return to_host(tree)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, full_every: int = 1):
        self.dir = directory
        self.keep = keep
        # 1: every save is full; k>1: one full save then k-1 deltas, repeating.
        self.full_every = max(1, int(full_every))
        self._thread: Optional[threading.Thread] = None
        # Digests of the last *published composed* tree, for delta diffing.
        # In-memory only: a fresh process always starts with a full save.
        self._published_step: Optional[int] = None
        self._published_digests: dict = {}
        self._since_full = 0
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, tree) -> str:
        """Synchronous atomic save."""
        return self._write(step, _host_tree(tree))

    def save_async(self, step: int, tree) -> None:
        """Copy to the host now, write on a background thread."""
        self.wait()
        host_tree = _host_tree(tree)  # device->host now
        self._thread = threading.Thread(target=self._write, args=(step, host_tree))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree) -> str:
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        blobs = {
            "/".join(path): np.ascontiguousarray(np.asarray(leaf))
            for path, leaf in _flatten(host_tree)
        }
        digests = {p: _digest(a) for p, a in blobs.items()}
        # Re-writing a step (or rewinding) would make a delta its own base
        # after the rmtree below — force full whenever step doesn't advance.
        full = (
            self.full_every <= 1
            or self._published_step is None
            or step <= self._published_step
            or self._since_full >= self.full_every - 1
        )
        if full:
            written = sorted(blobs)
        else:
            prev = self._published_digests
            written = sorted(p for p, d in digests.items() if prev.get(p) != d)
        for p in written:
            fn = os.path.join(tmp, p.replace("/", "__") + ".npy")
            np.save(fn, blobs[p])
        manifest = {
            "step": step,
            "kind": "full" if full else "delta",
            "base_step": None if full else self._published_step,
            "tree": _manifest_of(host_tree),
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)  # atomic publish
        self._published_step = step
        self._published_digests = digests
        self._since_full = 0 if full else self._since_full + 1
        self._gc()
        return final

    def _gc(self) -> None:
        if not self.keep:
            return
        steps = self.all_steps()
        kept = set(steps[-self.keep :])
        # A kept delta is useless without its base chain: protect every
        # step reachable through base_step links from a kept step.
        protected = set()
        frontier = list(kept)
        while frontier:
            s = frontier.pop()
            if s in protected:
                continue
            protected.add(s)
            base = self._manifest(s).get("base_step")
            if base is not None and base not in protected:
                frontier.append(base)
        for s in steps:
            if s not in protected:
                shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "MANIFEST.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:09d}", "MANIFEST.json")) as f:
            return json.load(f)

    def _leaves_in(self, step: int) -> dict:
        final = os.path.join(self.dir, f"step_{step:09d}")
        out = {}
        for name in os.listdir(final):
            if name.endswith(".npy"):
                out[name[: -len(".npy")].replace("__", "/")] = os.path.join(final, name)
        return out

    def restore(self, step: Optional[int] = None, shardings=None):
        """Load a checkpoint as ``(step, tree)``.  A delta checkpoint
        composes transparently: leaves it did not write are pulled from its
        base chain (checkpoints without a ``kind`` field read as full).

        Leaves are numpy arrays; ``shardings``, a tree of the saved
        structure whose leaves are a ``torch.device`` (or a name), a
        ``sharding.Placement`` or None, makes each leaf a tensor on its
        device, or a ``Sharded`` of it on the placement's mesh (None keeps
        the numpy leaf)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        manifest = self._manifest(step)
        needed = set(_leaf_paths(manifest["tree"]))
        leaves = {}
        cursor = step
        while needed:
            for p, fn in self._leaves_in(cursor).items():
                if p in needed:
                    leaves[p] = np.load(fn)
                    needed.discard(p)
            if not needed:
                break
            cur_manifest = manifest if cursor == step else self._manifest(cursor)
            base = cur_manifest.get("base_step")
            if base is None:
                raise FileNotFoundError(
                    f"step {step} is missing leaves {sorted(needed)[:4]}... "
                    "and has no base checkpoint to compose them from"
                )
            cursor = base
        tree = _unflatten(leaves, manifest["tree"])
        if shardings is not None:
            tree = _place(tree, shardings)
        return step, tree


def _place(tree, shardings):
    """``tree``'s leaves as tensors on the devices of the matching leaves
    of ``shardings``, or ``Sharded`` by a ``Placement`` there (None: the
    leaf stays as it is)."""
    if isinstance(tree, dict):
        if set(tree) != set(shardings):
            raise ValueError(f"shardings keys {sorted(shardings)} != saved {sorted(tree)}")
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [_place(v, d) for v, d in zip(tree, shardings, strict=True)]
        return tuple(seq) if isinstance(tree, tuple) else seq
    if shardings is None:
        return tree
    if isinstance(shardings, sharding.Placement):
        return shardings.place(tree)
    return torch.as_tensor(tree, device=torch.device(shardings))


# ---------------------------------------------------------------------------
# Elastic mesh rescale: restore any checkpoint onto any mesh
# ---------------------------------------------------------------------------


def shardings_for_schema(schema, mesh: sharding.Mesh) -> dict:
    """A ``Placement`` per leaf of a param schema on ``mesh``
    (``layers.param_specs`` under it)."""
    from repro_torch.models import layers

    with sharding.activate(mesh):
        specs = layers.param_specs(schema)
    return _map_specs(lambda s: sharding.Placement(mesh, s), specs)


def _map_specs(fn, specs, *rest):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(r[k] for r in rest)) for k, v in specs.items()}
    return fn(specs, *rest)


def reshard_tree(tree, mesh: sharding.Mesh, specs) -> dict:
    """A live tree onto ``mesh``: each leaf a ``Sharded`` by its
    PartitionSpec in ``specs`` (its slices on their entries; ``gather``
    gives the whole leaf back)."""
    return _map_specs(lambda s, a: sharding.Placement(mesh, s).place(a), specs, tree)


def rescale(manager: CheckpointManager, schema, new_mesh: sharding.Mesh, step=None):
    """Restore a checkpoint (the latest, or ``step``) of a model's params
    onto a mesh of another size: ``(step, tree of Sharded)``."""
    return manager.restore(step=step, shardings=shardings_for_schema(schema, new_mesh))


def restore_train_state(manager: CheckpointManager, cfg, mesh: sharding.Mesh,
                        tcfg: TrainConfig = TrainConfig(), step=None):
    """Restore a checkpoint (the latest, or ``step``) of a model's
    ``TrainState``, partitioned or whole (a ``Sharded`` leaf is saved
    whole), as a partitioned state on ``mesh``: ``(step, state)``, laid out
    by ``models.model.place_train_state`` (the params by
    ``shardings_for_schema``, the moments by their ZeRO-1 placements)."""
    from repro_torch import convert
    from repro_torch.models import model

    step, host = manager.restore(step=step)
    state = convert.train_state_from_numpy(host, cfg, "cpu", tcfg)
    return step, model.place_train_state(state, mesh, cfg, tcfg)
