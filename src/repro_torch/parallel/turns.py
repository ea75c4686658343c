"""Every rank of a mesh in one process, one rank at a time.

A program written for a `DeviceMesh` (the block program of
`sharding.BLOCK_FAMILIES`, any `shard_map` body) runs here on one card
as the mesh's N ranks in N threads that take turns: rank r runs until
its next collective, leaves its operand, and hands the turn to rank
r + 1; when the last rank has left its operand, every line's collective
is done at once as stacked tensor ops (an all-gather a `cat`, a
psum-scatter a sum and a chunk, an all-to-all the chunks swapped, a psum
or pmax a sum or max), and rank 0 resumes with its result. SPMD ranks
issue the same collectives in the same order, each on its own line, so
every rank has left one when the turn wraps. Only one rank runs at a
time, and its device time between two collectives is read on CUDA
events: a rank's ms, as one card of a real mesh would take for its
share, less the collectives (which a mesh moves over its links).

    turns = Turns((2, 16), ("data", "model"))
    outs = turns.run(lambda r: step(...))      # one result per rank
    turns.ms                                   # each rank's device ms

Each thread enters `sharding.use_mesh` with its own `LocalMesh` (the
rank grid, this rank's coordinates), so `sharding._line` gives it its
lines, and the collectives of `sharding` hand their operands to the
`Turns` of the line. Autograd runs each backward on its caller's thread
(`torch.autograd.set_multithreading_enabled(False)` in each rank's
thread: on a card the backward would otherwise run on autograd's one
device thread, where a rank waiting at a collective would block the
next rank's backward), so a rank's backward takes its turns as its
forward does.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.parallel import sharding


# a rank that waits this long for its turn is deadlocked (ranks issuing
# their collectives in other orders): every rank raises
TURN_TIMEOUT_S = 300


class LocalMesh:
    """The `DeviceMesh` surface `sharding` reads, for rank `rank` of a
    mesh of `shape` run by `turns`."""

    def __init__(self, shape: tuple, axes: tuple, rank: int, turns):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(shape)
        self.mesh = torch.arange(int(torch.tensor(shape).prod())).reshape(
            shape)
        self.rank = rank
        self.turns = turns

    def size(self) -> int:
        return self.mesh.numel()


class Turns:
    """N rank threads taking turns, their collectives done as stacked
    tensor ops (the module docstring). `timed` reads each rank's device
    ms between its collectives on CUDA events (the card only)."""

    def __init__(self, shape: tuple, axes: tuple, *, timed: bool = False,
                 **mesh_kw):
        self.shape, self.axes = tuple(shape), tuple(axes)
        self.mesh_kw = mesh_kw
        self.n = int(torch.tensor(shape).prod())
        self.timed = timed
        self._cv = threading.Condition()
        self._turn = 0
        self._pending: dict = {}
        self._results: dict = {}
        self._done: set = set()
        self._error = None
        self._spans: list = [[] for _ in range(self.n)]
        self._open: list = [None] * self.n
        self.collectives = 0

    # -- the threads --------------------------------------------------------
    def run(self, fn) -> list:
        """fn(r) on every rank r, in turns, each inside `use_mesh` of its
        `LocalMesh`; returns the N results, in rank order."""
        out = [None] * self.n

        def rank(r):
            try:
                # a backward on this thread, not on autograd's device
                # thread (the flag is the thread's own)
                torch.autograd.set_multithreading_enabled(False)
                with sharding.use_mesh(LocalMesh(self.shape, self.axes, r,
                                                 self), **self.mesh_kw):
                    with self._cv:
                        self._wait(lambda: self._turn == r)
                    self._start(r)
                    out[r] = fn(r)
                    self._stop(r)
            except BaseException as e:              # noqa: BLE001
                with self._cv:
                    if self._error is None:
                        self._error = e
                    self._cv.notify_all()
                return
            with self._cv:
                self._done.add(r)
                self._advance(r)
        threads = [threading.Thread(target=rank, args=(r,), daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._raise()
        return out

    def _wait(self, ready):
        """Wait (holding the lock) until `ready()` or a rank failed."""
        if not self._cv.wait_for(lambda: ready() or self._error is not None,
                                 timeout=TURN_TIMEOUT_S):
            self._error = TimeoutError(f"no turn in {TURN_TIMEOUT_S} s")
            self._cv.notify_all()
        self._raise()

    def _raise(self):
        if self._error is not None:
            raise RuntimeError("a rank failed") from self._error

    # -- a rank's device time -------------------------------------------------
    def _start(self, r):
        if self.timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._open[r] = ev

    def _stop(self, r):
        if self.timed and self._open[r] is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._spans[r].append((self._open[r], ev))
            self._open[r] = None

    @property
    def ms(self) -> list:
        """Each rank's device ms between its collectives (0 untimed)."""
        if not self.timed:
            return [0.0] * self.n
        torch.cuda.synchronize()
        return [sum(a.elapsed_time(b) for a, b in s) for s in self._spans]

    # -- the collectives ------------------------------------------------------
    def exchange(self, rank: int, line, op: str, x, *args):
        """Rank `rank`'s operand of collective `op` on `line` (a
        `sharding._Line`); returns its result once every rank has left
        its own."""
        with self._cv:
            self._stop(rank)
            self._pending[rank] = (line, op, x, args)
            self._advance(rank)
            self._wait(lambda: self._turn == rank and rank in self._results)
            out = self._results.pop(rank)
        self._start(rank)
        return out

    def _advance(self, r):
        """Hand the turn on from rank r (the caller holds the lock)."""
        live = [q for q in range(self.n) if q not in self._done]
        later = [q for q in live if q > r]
        if later:
            self._turn = later[0]
        elif live:
            try:
                self._collect(live)
            except BaseException as e:              # noqa: BLE001
                self._error = e
            self._turn = live[0]
        self._cv.notify_all()

    def _collect(self, live):
        """Every pending collective, line by line, as stacked ops."""
        missing = [q for q in live if q not in self._pending]
        if missing:
            raise RuntimeError(f"ranks {missing} left the program while "
                               "others wait at a collective")
        lines: dict = {}
        for q, (line, op, x, args) in self._pending.items():
            lines.setdefault((line.ranks, op, args), {})[line.index] = (q, x)
        for (ranks, op, args), members in lines.items():
            xs = [members[j][1] for j in range(len(ranks))]
            outs = _stacked(op, xs, args)
            for j, (q, _) in members.items():
                self._results[q] = outs[j]
        self.collectives += 1
        self._pending.clear()


def _stacked(op: str, xs: list, args: tuple) -> list:
    """One collective over the operands `xs` of a line's ranks in JAX's
    order: each rank's result, a tensor of its own."""
    n = len(xs)
    if op == "all_gather":
        return _owned(torch.cat(xs, args[0]), n)
    if op == "psum_scatter":
        return [c.clone(memory_format=torch.contiguous_format)
                for c in sum(xs).chunk(n, args[0])]
    if op == "all_to_all":
        split, concat = args
        parts = [x.chunk(n, split) for x in xs]
        return [torch.cat([p[j] for p in parts], concat) for j in range(n)]
    if op == "SUM":
        return _owned(sum(xs[1:], xs[0].clone()), n)
    if op == "MAX":
        return _owned(torch.stack(xs).amax(0), n)
    raise ValueError(op)


def _owned(t, n: int) -> list:
    """`t` for the first rank and a copy of it for each other: every
    rank's result a tensor of its own."""
    return [t] + [t.clone() for _ in range(n - 1)]
