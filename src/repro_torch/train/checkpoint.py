"""Checkpointing: tree save/restore, async writes, the reference's format.

The port of the reference's `repro.train.checkpoint`, on disk the same:

    <dir>/step_<9 digits>/
        tensors.npz      keypath -> array (`tree.flatten_with_keys`)
        meta.json        {step, keys, metadata}

written into `step_<n>.tmp` and renamed in place, the oldest beyond
`keep` removed, by one background writer (the host copies are taken
before `save` returns, so the caller may update its tensors at once).
A checkpoint written by either package restores in the other.

A bfloat16 leaf is stored as the reference stores it: numpy has no
bfloat16, so `np.savez` writes its two-byte bit patterns as raw void
(``|V2``). `restore` reads such a leaf back as `torch.bfloat16` with
the same bits. The reference's own restore hands the ``|V2`` array back
unconverted, and its next jitted step fails on it, so it cannot resume
a bf16 (full-width) run; the port can.

`restore(template, step, spec_tree)` fills `template` by keypath: a
tensor leaf gives the device (and must give the stored shape and dtype),
any other leaf means the package default device.

On a mesh (a `DeviceMesh` in `sharding.use_mesh`, `spec_tree` given: a
tree of module Specs like the state's) the state is a rank's blocks
(`train_loop.shard_train_state`). `save` gathers every leaf whole on
every rank and rank 0 writes it, in the format above, before all ranks
go on; `restore` reads the whole leaves and cuts this rank's block under
the current mesh's specs, the reference's elastic reshard. A checkpoint
written on one mesh so resumes on another, in one process, or in the
reference.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import tree
from repro_torch.convert import to_tensor
from repro_torch.device import resolve
from repro_torch.models.module import is_spec
from repro_torch.parallel import sharding


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # .cpu() copies a card tensor; a CPU tensor is copied here, so
        # the writer never reads what later in-place updates make of it
        t = leaf.detach().cpu()
        if leaf.device.type == "cpu":
            t = t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    a = np.asarray(leaf)
    return a.view("V2") if a.dtype.name == "bfloat16" else a


def flatten_with_keys(state) -> dict[str, np.ndarray]:
    """{keypath: host copy} of every leaf (bf16 as its ``|V2`` bits)."""
    return {k: _to_numpy(leaf) for k, leaf in tree.flatten_with_keys(state)}


def _from_numpy(arr: np.ndarray, like, key: str, spec=None) -> torch.Tensor:
    if arr.dtype == np.dtype("V2"):
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = to_tensor(arr, "cpu").clone()
    if spec is not None:
        t = sharding.shard_tree(t, spec)
    if isinstance(like, torch.Tensor):
        if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
            raise ValueError(f"checkpoint leaf {key}: {tuple(t.shape)} "
                             f"{t.dtype}, the template's "
                             f"{tuple(like.shape)} {like.dtype}")
        return t.to(like.device)
    return t.to(resolve(None))


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1) if async_write else None
        self._pending = None
        os.makedirs(directory, exist_ok=True)

    # -- write ------------------------------------------------------------
    def save(self, step: int, state: dict, metadata: dict | None = None,
             spec_tree=None):
        """state: a tree of tensors, e.g. {'params': ..., 'opt': ...}; on
        a mesh with `spec_tree`, a rank's blocks, gathered whole and
        written by rank 0 (every rank calls)."""
        if _on_mesh(spec_tree):
            import torch.distributed as dist
            whole = sharding.unshard_tree(state, spec_tree)
            if dist.get_rank() == 0:
                self.wait()
                self._write(step, flatten_with_keys(whole), metadata or {})
            dist.barrier()
            return
        flat = flatten_with_keys(state)        # host copies happen here
        if self._pool is not None:
            self.wait()
            self._pending = self._pool.submit(self._write, step, flat,
                                              metadata or {})
        else:
            self._write(step, flat, metadata or {})

    def _write(self, step: int, flat: dict, metadata: dict):
        d = os.path.join(self.dir, f"step_{step:09d}")
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "tensors.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "keys": sorted(flat),
                       "metadata": metadata}, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)                       # atomic publish
        self._gc()

    def wait(self):
        """Block until the pending write is on disk; raise its error."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self):
        """Finish the pending write and stop the writer thread."""
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- read -------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_")
                      and not name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None,
                spec_tree=None) -> tuple[int, dict]:
        """(step, `template` refilled from checkpoint `step`, the latest
        when None): on a mesh with `spec_tree`, this rank's blocks."""
        specs = (tree.leaves(spec_tree, is_leaf=is_spec)
                 if _on_mesh(spec_tree) else None)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with np.load(os.path.join(d, "tensors.npz")) as data:
            leaves = [_from_numpy(data[k], like, k,
                                  None if specs is None else specs[i])
                      for i, (k, like) in enumerate(
                          tree.flatten_with_keys(template))]
        return step, tree.unflatten(template, leaves)


def _on_mesh(spec_tree) -> bool:
    """A spec tree given under a `DeviceMesh`: the state is blocks."""
    return spec_tree is not None and sharding.ranks_in_use()
