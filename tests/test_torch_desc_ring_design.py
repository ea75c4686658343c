"""The device CQ ring's Hopper design on the CPU: the per-CTA schedule
model (`ref.schedule`, run on `ops.plan`'s plans) against the JAX
reference's ring, the plan's CTA counts and its parameters-or-staging
switch, the CPU wrappers (no launch, no pinned memory), and the auto
device-residency policy on a CPU device. Inputs are made with numpy from
a seed; rows, k, slots and flags are compared bit for bit."""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hyp import given, settings, strategies as st

from repro.kernels.desc_ring import ops as jring
from repro.kernels.desc_ring import ref as jring_ref
from repro_torch import device as tdevice
from repro_torch import verbs as tverbs
from repro_torch.core import notification as tnotif
from repro_torch.kernels import _build
from repro_torch.kernels.desc_ring import ops as tring
from repro_torch.kernels.desc_ring import ref as tring_ref

W = 8


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.set_default("cpu")
    yield
    tdevice.set_default(prev)


def _batch(rng, n):
    return rng.integers(-2**62, 2**62, (n, W), dtype=np.int64)


def _jslots(slots) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(slots)).view(np.int64)


class Model:
    """The schedule model on torch slots beside the JAX reference's
    jitted ring and its numpy oracle, driven through the same calls."""

    def __init__(self, cap, per_cta):
        self.cap, self.per_cta = cap, per_cta
        self.slots = torch.zeros((cap, W), dtype=torch.int64)
        self.flags = torch.zeros((cap,), dtype=torch.uint8)
        self.j_slots, self.j_flags = jring.alloc(cap, W)
        self.o_slots = np.zeros((cap, W), np.int64)
        self.o_flags = np.zeros((cap,), np.uint8)
        self.head = self.tail = 0
        self.grids = []

    def call(self, entry, batch, limit):
        """One call of `entry` (head and tail move as a Ring moves
        them); returns the plan, the model's rows and the reference's."""
        cap = self.cap
        n = batch.shape[0]
        produce, consume = entry != "ring_consume", entry != "ring_produce"
        h, t = self.head % (2 * cap), self.tail % (2 * cap)
        pl = tring.plan(cap, h, t, n, limit, produce=produce,
                        consume=consume, per_cta=self.per_cta)
        self.grids.append(pl.grid)
        rows, kwords = tring_ref.schedule(
            self.slots, self.flags, pl, h, t,
            torch.from_numpy(batch) if produce else None,
            limit if consume else 0)
        got = rows[:int(kwords.min())].numpy() if consume else None
        want = None
        if entry == "ring_produce":
            self.j_slots, self.j_flags = jring.produce(
                self.j_slots, self.j_flags, self.head, batch)
        elif entry == "ring_consume":
            want = jring.consume(self.j_slots, self.j_flags, self.tail,
                                 limit)
        else:
            self.j_slots, self.j_flags, want = jring.produce_consume(
                self.j_slots, self.j_flags, self.head, self.tail, batch,
                limit)
        if produce and n:
            self.o_slots, self.o_flags = jring_ref.reference_produce(
                self.o_slots, self.o_flags, batch, self.head)
            self.head += n
        if consume:
            rot, k = jring_ref.reference_consume(self.o_slots, self.o_flags,
                                                 self.tail)
            np.testing.assert_array_equal(want, rot[:min(k, limit)])
            self.tail += got.shape[0]
        return pl, got, want

    def check_state(self):
        np.testing.assert_array_equal(self.slots.numpy(),
                                      _jslots(self.j_slots))
        np.testing.assert_array_equal(self.flags.numpy(),
                                      np.asarray(self.j_flags))
        np.testing.assert_array_equal(self.slots.numpy(), self.o_slots)
        np.testing.assert_array_equal(self.flags.numpy(), self.o_flags)


CAP = 24


@pytest.mark.parametrize("ctas", [1, 2, 3, "many"])
def test_schedule_matches_reference_over_three_laps(ctas):
    """Mixed traffic over three laps, each call's plan cut into 1, 2, 3
    or one-slot CTAs: the model's rows, k, slots and flags equal the JAX
    reference's ring (jitted ops and numpy oracle) at every call,
    whichever CTA holds the first invalid position."""
    per = {1: CAP, 2: CAP // 2, 3: CAP // 3, "many": 1}[ctas]
    rng = np.random.default_rng(7)
    m = Model(CAP, per)
    entries = ("ring_produce", "ring_consume", "ring_produce_consume")
    for step in range(60):
        entry = entries[step % 3]
        room = CAP - (m.head - m.tail)
        n = int(rng.integers(0, room + 1)) if entry != "ring_consume" else 0
        limit = int(rng.integers(0, CAP + 1))
        pl, got, want = m.call(entry, _batch(rng, n), limit)
        if got is not None:
            np.testing.assert_array_equal(got, want)
        m.check_state()
        assert pl.grid <= -(-pl.span // per) or pl.grid == 1
    assert m.head > 3 * CAP and m.tail > 2 * CAP      # three laps
    full = {1: 1, 2: 2, 3: 3, "many": CAP}[ctas]
    assert full in m.grids


@pytest.mark.parametrize("ctas", [1, 2, 3, "many"])
def test_schedule_edges(ctas):
    """n = 0, limit = 0, n = cap, limit = cap, and a batch that wraps
    across the lap boundary inside one CTA's range."""
    per = {1: CAP, 2: CAP // 2, 3: CAP // 3, "many": 1}[ctas]
    rng = np.random.default_rng(11)
    m = Model(CAP, per)
    seq = [("ring_produce_consume", CAP, CAP),      # n = cap, limit = cap
           ("ring_produce_consume", 0, 0),          # nothing at all
           ("ring_produce", 0, 0),
           ("ring_consume", 0, 0),
           ("ring_produce", CAP - 2, 0),
           ("ring_consume", 0, CAP - 2),            # tail at cap - 2
           ("ring_produce_consume", 6, 3),          # wraps: lap 1 -> 2
           ("ring_consume", 0, CAP),                # k < limit
           ("ring_produce_consume", CAP - 3, CAP),
           ("ring_produce", CAP, 0),                # n = cap
           ("ring_consume", 0, CAP)]
    wrapped = False
    for entry, n, limit in seq:
        pl, got, want = m.call(entry, _batch(rng, n), limit)
        if got is not None:
            np.testing.assert_array_equal(got, want)
        m.check_state()
        if entry == "ring_produce_consume" and n == 6:
            # one CTA's range holds slot cap - 1 and slot 0
            for c in range(pl.grid):
                own = {(pl.base + j) % CAP for j in
                       range(c * pl.per, min((c + 1) * pl.per, pl.span))}
                wrapped |= {CAP - 1, 0} <= own
            assert got.shape[0] == 3 and m.head > 2 * CAP - 6
    assert wrapped == (ctas != "many")    # one-slot CTAs hold one slot


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("ctas", [2, 3, "many"])
def test_first_invalid_slot_in_any_cta_sets_k(where, ctas):
    """A full ring with one stale flag: the CTA that holds it writes its
    position, the others `limit`; k (their minimum) equals the JAX
    reference's, for the first, a middle and the last CTA."""
    per = {2: CAP // 2, 3: CAP // 3, "many": 1}[ctas]
    rng = np.random.default_rng(3)
    m = Model(CAP, per)
    m.call("ring_produce", _batch(rng, 17), 0)
    m.call("ring_consume", np.zeros((0, W), np.int64), 17)
    m.call("ring_produce", _batch(rng, CAP), 0)          # full, wraps
    pl = tring.plan(CAP, m.head % (2 * CAP), m.tail % (2 * CAP), 0, CAP,
                    produce=False, consume=True, per_cta=per)
    c = {"first": 0, "middle": pl.grid // 2, "last": pl.grid - 1}[where]
    i = c * pl.per + pl.per // 2
    s = (m.tail + i) % CAP
    m.flags[s] ^= 1
    m.o_flags[s] ^= 1
    rows, kwords = tring_ref.schedule(m.slots, m.flags, pl, m.tail % (2 * CAP),
                                      m.tail % (2 * CAP), None, CAP)
    rot, k = jring_ref.reference_consume(m.o_slots, m.o_flags, m.tail)
    assert int(kwords.min()) == k == i
    assert int(kwords[c]) == i
    assert all(int(kwords[d]) == CAP for d in range(pl.grid) if d != c)
    np.testing.assert_array_equal(rows[:k].numpy(), rot[:k])


@settings(deadline=None)
@given(st.data())
def test_schedule_equals_plain_version(data):
    """For any head, tail, n and limit a Ring could pass, the schedule
    model with the default plan computes what the plain version
    (`ref.produce` then `ref.consume`) computes."""
    cap = data.draw(st.sampled_from([1, 5, 32, 33, 100, 257]))
    tail = data.draw(st.integers(0, 2 * cap - 1))
    occ = data.draw(st.integers(0, cap))
    head = tail + occ
    n = data.draw(st.integers(0, cap - occ))
    limit = data.draw(st.integers(0, cap))
    rng = np.random.default_rng(cap * 1000 + tail)
    slots = torch.from_numpy(_batch(rng, cap))
    flags = torch.from_numpy(rng.integers(0, 2, cap).astype(np.uint8))
    b = torch.from_numpy(_batch(rng, n))
    s2, f2 = slots.clone(), flags.clone()
    pl = tring.plan(cap, head % (2 * cap), tail, n, limit, produce=True,
                    consume=True)
    rows, kwords = tring_ref.schedule(slots, flags, pl, head % (2 * cap),
                                      tail, b, limit)
    tring_ref.produce(s2, f2, head % (2 * cap), b)
    r2, k2 = tring_ref.consume(s2, f2, tail, limit)
    assert int(kwords.min()) == k2
    assert torch.equal(rows[:k2], r2[:k2])
    assert torch.equal(slots, s2) and torch.equal(flags, f2)


def test_plan_cta_counts():
    """A call of a few descriptors is one CTA of one warp; depth 4096 is
    128 CTAs of 32 slots; past MAX_CTAS CTAs the CTAs grow instead. The
    window covers the produced rows when they reach past the scan."""
    p = tring.plan(4096, 10, 10, 3, 3, produce=True, consume=True)
    assert (p.grid, p.threads, p.base, p.span) == (1, 32, 10, 3)
    p = tring.plan(4096, 0, 0, 4096, 4096, produce=True, consume=True)
    assert (p.grid, p.per, p.threads) == (128, 32, 128)
    p = tring.plan(1 << 16, 0, 0, 1 << 16, 1 << 16, produce=True,
                   consume=True)
    assert (p.grid, p.per, p.threads) == (tring.MAX_CTAS, 64, 128)
    # produce only: the window starts at the head's slot
    p = tring.plan(64, 70, 0, 5, 0, produce=True, consume=False)
    assert (p.base, p.span, p.grid) == (6, 5, 1)
    # consume only: the tail's slot, limit slots
    p = tring.plan(64, 0, 127, 0, 40, produce=False, consume=True)
    assert (p.base, p.span, p.grid) == (63, 40, 2)
    # fused: from the tail's slot to the last produced row
    p = tring.plan(64, 60, 50, 8, 2, produce=True, consume=True)
    assert (p.base, p.span) == (50, 18)
    # nothing to do is still one launch of one CTA
    p = tring.plan(64, 0, 0, 0, 0, produce=True, consume=True)
    assert (p.grid, p.span, p.tier) == (1, 0, 0)


@pytest.mark.parametrize("n,tier", [
    (1, 8), (8, 8), (9, 64), (64, 64), (65, tring.PARAM_MAX),
    (tring.PARAM_MAX - 1, tring.PARAM_MAX), (tring.PARAM_MAX,
                                             tring.PARAM_MAX),
    (tring.PARAM_MAX + 1, 0), (4096, 0), (0, 0)])
def test_plan_parameters_or_staging(n, tier):
    """The batch rides in the smallest parameter struct that holds it, up
    to PARAM_MAX descriptors (one past it: the staging buffer); a consume
    carries none."""
    assert tring.plan(4096, 0, 0, n, 0, produce=True,
                      consume=False).tier == tier
    assert tring.plan(4096, 0, 0, n, n, produce=True,
                      consume=True).tier == tier
    assert tring.plan(4096, 0, 0, n, n, produce=False,
                      consume=True).tier == 0


def test_param_max_fits_the_launch_parameters():
    """PARAM_MAX descriptors and the launch's other fields fit the
    32,764 bytes of kernel parameters CUDA 12.1 allows; one more does
    not (the kernel source's static_assert holds the same)."""
    head = 5 * 8 + 8 * 8                   # Step: 5 pointers, 8 int64
    aligned = -(-head // 16) * 16
    assert aligned + 64 * tring.PARAM_MAX <= 32764
    assert aligned + 64 * (tring.PARAM_MAX + 1) > 32764
    src = (_build.CSRC / "desc_ring.cu").read_text()
    assert f"kParamMax = {tring.PARAM_MAX};" in src


@pytest.mark.parametrize("n,limit,cls", [
    (0, 0, "n0 limit0"), (0, 1, "n0 limit1"), (3, 5, "n4 limit8"),
    (8, 8, "n8 limit8"), (4096, 4096, "n4096 limit4096"),
    (511, 0, "n512 limit0")])
def test_shape_class(n, limit, cls):
    assert tring.shape_class(n, limit) == cls


def test_cpu_wrappers_launch_nothing_and_pin_nothing(monkeypatch):
    """On CPU tensors the wrappers take the plain version: no library is
    loaded, no host memory pinned, no launch or shape class counted."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU path reached the card's boundary")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(tring, "_pin", refuse)
    monkeypatch.setattr(tring, "Boundary", refuse)
    launches, shapes = dict(_build.LAUNCHES), dict(_build.BY_SHAPE)
    shared = dict(tring._SHARED)
    rng = np.random.default_rng(5)
    slots, flags = tring.alloc(16, W, torch.device("cpu"))
    tring.produce(slots, flags, 0, _batch(rng, 10))
    assert tring.consume(slots, flags, 0, 4).shape == (4, W)
    assert tring.produce_consume(slots, flags, 10, 4, _batch(rng, 6),
                                 16).shape == (12, W)
    ring = tnotif.Ring(16, device=True, torch_device="cpu")
    assert ring._via is None
    ring.produce(_batch(rng, 5))
    assert ring.consume(None).shape == (5, W)
    assert _build.LAUNCHES == launches and _build.BY_SHAPE == shapes
    assert tring._SHARED == shared


@pytest.mark.parametrize("auto", [{}, {"cuda": 64}])
def test_cpu_device_resolves_to_a_host_ring(monkeypatch, auto):
    """Whatever `DEVICE_RING_AUTO_DEPTH` holds for `cuda`, a ring (and a
    CQ) left to the policy on a `cpu` device is a host ring."""
    monkeypatch.setattr(tnotif, "DEVICE_RING_AUTO_DEPTH",
                        dict(tnotif.DEVICE_RING_AUTO_DEPTH, **auto))
    for cap in (64, 4096, 8192):
        ring = tnotif.Ring(cap, torch_device=torch.device("cpu"))
        assert ring.device is False and isinstance(ring.slots, np.ndarray)
        assert not tnotif._auto_device(cap, True, torch.device("cpu"))
        assert tverbs.CompletionQueue(cap, 8, True).ring.device is False
