#!/usr/bin/env python3
"""Drive the torch port's verbs datapath on one CUDA card and hold every
kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py              # from the root of a checkout

It needs one CUDA card: without one it exits non-zero and reports
nothing. The same main path runs on the CPU at a small size in
`tests/test_torch_datapath.py::test_smoke_rig_matches_reference_and_oracle`.

Phases (any failure exits non-zero):
  1. the card (nvidia-smi name and power limit) and the kernel build;
  2. each kernel against its plain version on the card, exact, at the
     main path's shapes (4096 records of 4 KiB in a 12 GiB region, ring
     depth 4096) and at edge shapes; kernel, plain, library and bound
     times;
  3. the datapath against its scalar oracle: two rigs built from the
     verbs entry points, seeded from one numpy generator with a 12 GiB
     block MR; 4096-WR WRITE/READ/SEND chains and a 64-WR mixed chain
     with an RNR stall, bad-rkey and out-of-range WRs must give equal
     CQE streams, MR contents and
     counters; launches per flush and per fused poll are checked, and
     every kernel must have launched on the main path;
  4. timing of each chain on the vectorized rig (median of 5).
The last three lines are the card's `nvidia-smi` line, one JSON object
with a row per kernel, and `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)


@dataclass(frozen=True)
class Sizes:
    blocks: int         # records in the server's block MR
    rec: int            # float32 elements per record (4 KiB)
    n: int              # WRs per chain
    ring: int           # server recv CQ / ring depth
    mixed: int          # WRs in the mixed chain
    reps: int           # timing repetitions


FULL = Sizes(blocks=3 << 20, rec=1024, n=4096, ring=4096, mixed=64, reps=5)


def check(cond, msg: str):
    if not cond:
        raise AssertionError(msg)


def log(*parts):
    print(*parts, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Milliseconds per call on the card, from CUDA events, after a
    warm-up. `cold=True` evicts the
    50 MB L2 before every call (a 256 MiB memset outside the timed
    window) and times each call alone: a WRITE run lands in rows of a
    12 GiB region that no earlier launch touched, so warm-cache repeats
    of the same rows would flatter every version alike."""

    def __init__(self, torch):
        self.torch = torch
        self._evict = None

    def ms(self, fn, iters: int = 20, warmup: int = 3,
           cold: bool = False) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        if not cold:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / iters
        if self._evict is None:
            self._evict = torch.empty(64 << 20, dtype=torch.float32,
                                      device="cuda")
        pairs = []
        for _ in range(iters):
            self._evict.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters

    def sync(self):
        self.torch.cuda.synchronize()


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# -- phase 2 --------------------------------------------------------------------
def phase_kernels(torch, np, dev, S, rng, T) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.desc_ring import ops as ring_ops
    from repro_torch.kernels.desc_ring import ref as ring_ref
    from repro_torch.kernels.wr_scatter import ops as wr_ops
    from repro_torch.kernels.wr_scatter import ref as wr_ref

    rows = {}
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    R, L, m = S.blocks, S.rec, S.n
    row_bytes = L * 4
    # -- scatter + gather at the main path's shape (12 GiB region) ----------
    region = torch.rand((R, L), generator=gen, device=dev)
    plain = region.clone()
    offs = rng.choice(S.blocks, size=m, replace=False)
    check((offs >= (1 << 31) // L).any(), "no offset past element 2^31")
    offs_t = torch.from_numpy(offs).to(dev)
    vals = torch.rand((m, L), generator=gen, device=dev)
    wr_ops.scatter_records(region, offs, vals)
    wr_ref.scatter(plain, offs_t, vals)
    T.sync()
    check(torch.equal(region, plain), "scatter_rows != plain scatter")
    err = float((region[offs_t] - plain[offs_t]).abs().max())
    move = 2 * m * row_bytes + 8 * m
    lib = _build.load("wr_rows", wr_ops._SIG)
    stream = _build.stream_ptr(dev)

    def k_scatter():
        _build.check(lib, lib.scatter_rows(
            region.data_ptr(), vals.data_ptr(), offs_t.data_ptr(), m,
            row_bytes, stream), "scatter_rows")
    k_ms = T.ms(k_scatter, cold=True)
    rows["wr_scatter"] = dict(
        name="wr_scatter", route="cuda",
        source="src/repro_torch/csrc/wr_rows.cu",
        replaces="src/repro/kernels/wr_scatter/wr_scatter.py:27",
        max_abs_err=err, ms=k_ms,
        plain_ms=T.ms(lambda: wr_ref.scatter(plain, offs_t, vals),
                      cold=True),
        bound_ms=bound_ms(move), bound_by="bytes",
        library_ms=T.ms(lambda: plain.index_put_((offs_t,), vals),
                        cold=True),
        shape=f"{m}x{row_bytes}B into {R}x{row_bytes}B")
    del plain
    got = wr_ops.gather_records(region, offs, L)
    exp = wr_ref.gather(region, offs_t, L)
    T.sync()
    check(torch.equal(got, exp), "gather_rows != plain gather")
    check(torch.equal(got, vals), "gather did not read back the scatter")
    err = float((got - exp).abs().max())
    out = torch.empty_like(got)

    def k_gather():
        _build.check(lib, lib.gather_rows(
            out.data_ptr(), region.data_ptr(), offs_t.data_ptr(), m,
            row_bytes, stream), "gather_rows")
    k_ms = T.ms(k_gather, cold=True)
    rows["wr_gather"] = dict(
        name="wr_gather", route="cuda",
        source="src/repro_torch/csrc/wr_rows.cu",
        replaces="src/repro/kernels/wr_scatter/ops.py:48",
        max_abs_err=err, ms=k_ms,
        plain_ms=T.ms(lambda: wr_ref.gather(region, offs_t, L),
                      cold=True),
        bound_ms=bound_ms(move), bound_by="bytes",
        library_ms=T.ms(lambda: region.index_select(0, offs_t),
                        cold=True),
        shape=f"{m}x{row_bytes}B from {R}x{row_bytes}B")
    # an empty run launches nothing, so it counts as no launch
    before = dict(_build.LAUNCHES)
    wr_ops.scatter_records(region, offs[:0], vals[:0])
    check(wr_ops.gather_records(region, offs[:0], L).shape == (0, L),
          "empty gather shape")
    check(_build.LAUNCHES == before, "an empty run counted a launch")
    del region, got, exp, vals
    torch.cuda.empty_cache()
    log(f"phase 2: scatter/gather at {m} x {row_bytes} B in a "
        f"{R * row_bytes / 2**30:.1f} GiB region: exact")

    # -- edge shapes: ragged row widths, dtypes, misaligned base pointers --
    for dtype, rec in ((torch.uint8, (5,)), (torch.int32, (3,)),
                       (torch.float32, (1023,)), (torch.bfloat16, (7,)),
                       (torch.float32, (2, 8))):
        F = int(np.prod(rec))
        for shift in (0, 1):
            base = (torch.rand((40 * F + 1,), generator=gen, device=dev)
                    * 200).to(dtype)
            reg = base[shift:shift + 40 * F].view((40,) + rec)
            pl = reg.clone()
            o = rng.choice(40, size=13, replace=False)
            vb = (torch.rand((13 * F + 1,), generator=gen, device=dev)
                  * 200).to(dtype)
            v = vb[shift:shift + 13 * F].view((13,) + rec)
            wr_ops.scatter_records(reg, o, v)
            wr_ref.scatter(pl, torch.from_numpy(o).to(dev), v)
            T.sync()
            check(torch.equal(reg, pl), f"scatter edge {dtype} {rec} {shift}")
            g = wr_ops.gather_records(reg, o, F)
            check(torch.equal(g, wr_ref.gather(
                reg, torch.from_numpy(o).to(dev), F)),
                f"gather edge {dtype} {rec} {shift}")
    log("phase 2: scatter/gather edge shapes (uint8/int32/float32/bfloat16,"
        " rows of 5/12/4092/14/64 B, misaligned bases): exact")

    # -- desc_ring at depth S.ring: produce / consume / produce_consume ------
    cap, width = S.ring, 8
    ks, kf = ring_ops.alloc(cap, width, dev)
    ps, pf = ring_ops.alloc(cap, width, dev)

    def plain_pc(head, tail, batch, limit, produce=True, consume=True):
        if produce:
            ring_ref.produce(ps, pf, head % (2 * cap),
                             torch.from_numpy(batch).to(dev))
        if consume:
            r, k = ring_ref.consume(ps, pf, tail % (2 * cap), limit)
            return r[:k].cpu().numpy()
        return None

    def batch_of(n):
        return rng.integers(-2**62, 2**62, (n, width), dtype=np.int64)

    errs = {"ring_produce": 0, "ring_consume": 0, "ring_produce_consume": 0}
    head = tail = 0
    # three laps of mixed traffic: partial batches, partial polls, batches
    # that wrap across the lap boundary, empty polls
    for step in range(12):
        n = int(rng.integers(1, cap - (head - tail) + 1)) \
            if head - tail < cap else 0
        batch = batch_of(n)
        limit = int(rng.integers(0, cap + 1))
        if step % 3 == 0 and n:
            ring_ops.produce(ks, kf, head, batch)
            plain_pc(head, tail, batch, 0, consume=False)
            head += n
            fn = "ring_produce"
            got = exp = np.zeros((0, width), np.int64)
        elif step % 3 == 1:
            got = ring_ops.consume(ks, kf, tail, limit)
            exp = plain_pc(head, tail, batch, limit, produce=False)
            fn = "ring_consume"
        else:
            got = ring_ops.produce_consume(ks, kf, head, tail, batch, limit)
            exp = plain_pc(head, tail, batch, limit)
            head += n
            fn = "ring_produce_consume"
        check(np.array_equal(got, exp), f"{fn} rows != plain at step {step}")
        check(torch.equal(ks, ps) and torch.equal(kf, pf),
              f"{fn} ring state != plain at step {step}")
        if got.size:
            errs[fn] = max(errs[fn], int(np.abs(got - exp).max()))
        tail += got.shape[0]
    check(head > 2 * cap, "ring test did not cross two laps")
    log(f"phase 2: desc_ring at depth {cap}, {head // cap} laps: exact")
    full_batch = batch_of(cap)
    out = torch.empty((cap + 1, width), dtype=torch.int64, device=dev)
    bt = torch.from_numpy(full_batch).to(dev)
    moves = {"ring_produce": 2 * cap * 64 + cap,
             "ring_consume": cap * 65 + (cap + 1) * 64,
             "ring_produce_consume": 2 * cap * 64 + cap + cap * 65
             + (cap + 1) * 64}
    rlib = _build.load("desc_ring", ring_ops._SIG)
    args = {
        "ring_produce": (ks.data_ptr(), kf.data_ptr(), cap, width,
                         bt.data_ptr(), cap, 0, stream),
        "ring_consume": (ks.data_ptr(), kf.data_ptr(), cap, width, 0,
                         cap, out.data_ptr(), stream),
        "ring_produce_consume": (ks.data_ptr(), kf.data_ptr(), cap,
                                 width, bt.data_ptr(), cap, 0, 0, cap,
                                 out.data_ptr(), stream)}

    def raw(fn):
        return lambda: _build.check(rlib, getattr(rlib, fn)(*args[fn]), fn)
    wrappers = {
        "ring_produce": lambda: ring_ops.produce(ks, kf, 0, full_batch),
        "ring_consume": lambda: ring_ops.consume(ks, kf, 0, cap),
        "ring_produce_consume": lambda: ring_ops.produce_consume(
            ks, kf, 0, 0, full_batch, cap)}
    plains = {
        "ring_produce": lambda: plain_pc(0, 0, full_batch, cap,
                                         consume=False),
        "ring_consume": lambda: plain_pc(0, 0, full_batch, cap,
                                         produce=False),
        "ring_produce_consume": lambda: plain_pc(0, 0, full_batch, cap)}
    defs = {"ring_produce": 24, "ring_consume": 35,
            "ring_produce_consume": 48}
    for fn in ("ring_produce", "ring_consume", "ring_produce_consume"):
        rows[fn] = dict(
            name=f"desc_ring.{fn.removeprefix('ring_')}", route="cuda",
            source="src/repro_torch/csrc/desc_ring.cu",
            replaces=f"src/repro/kernels/desc_ring/desc_ring.py:{defs[fn]}",
            max_abs_err=float(errs[fn]),
            ms=T.ms(raw(fn)),
            wrapper_ms=T.ms(wrappers[fn]),
            plain_ms=T.ms(plains[fn]),
            bound_ms=bound_ms(moves[fn]), bound_by="bytes",
            library_ms=None, shape=f"depth {cap} x 64 B")
    for r in rows.values():
        log(f"phase 2: {r['name']:<26} {r['shape']:<36} kernel "
            f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms  library {r['library_ms']}")
    return rows


# -- phase 3 ----------------------------------------------------------------------
class Rig:
    """One client/server RC pair built from the verbs entry points: the
    server holds the block MR and an SRQ; its recv CQ is device-resident
    with the fused poll armed on the vectorized rig (the serve engine's
    configuration), a host ring on the scalar oracle."""

    def __init__(self, V, regions_from_numpy, vectorized, data, S):
        V.ProtectionDomain._next_key = 0x10000
        self.V, self.vec = V, vectorized
        self.pd = V.ProtectionDomain()
        self.mrs = regions_from_numpy(self.pd, data)
        self.srq = V.SharedReceiveQueue(max_wr=2 * S.n + S.mixed + 64)
        self.ccq = V.CompletionQueue(2 * S.n + 2 * S.mixed, 8, vectorized)
        self.scq = V.CompletionQueue(64, 8, vectorized)
        self.rcq = V.CompletionQueue(S.ring, 8, vectorized,
                                     device_ring=vectorized)
        if vectorized:
            self.rcq.enable_fused_poll()
        self.client = V.QueuePair(self.pd, self.ccq, max_send_wr=2 * S.n,
                                  vectorized=vectorized)
        self.server = V.QueuePair(self.pd, self.scq, self.rcq, srq=self.srq,
                                  vectorized=vectorized)
        V.connect(self.client, self.server,
                  V.LoopbackTransport(vectorized=vectorized))

    def counters(self) -> dict:
        return {"doorbell_writes": self.client.doorbell_writes,
                "desc_fetch_dmas": self.client.desc_fetch_dmas,
                "recv_ring_dma_writes": self.rcq.ring.dma_writes,
                "recv_ring_dma_reads": self.rcq.ring.dma_reads,
                "send_ring_dma_writes": self.ccq.ring.dma_writes,
                "send_ring_dma_reads": self.ccq.ring.dma_reads}

    def chain(self, kind: str, D: dict, S: Sizes) -> list:
        V = self.V
        W, R = V.IBV_WR_RDMA_WRITE, V.IBV_WR_RDMA_READ
        blk, loc = self.mrs["blocks"], self.mrs["local"]
        offs, pay, small = D["offs"], D["payload"], D["small"]
        n = S.n
        if kind == "write":
            return [V.SendWR(wr_id=i, opcode=W, remote_key=blk.rkey,
                             remote_offsets=offs[i:i + 1],
                             payload=pay[i:i + 1]) for i in range(n)]
        if kind in ("read", "read_land"):
            land = {} if kind == "read" else None
            return [V.SendWR(wr_id=i, opcode=R, remote_key=blk.rkey,
                             remote_offsets=offs[i:i + 1],
                             **(land if land is not None
                                else dict(mr=loc, offsets=[i])))
                    for i in range(n)]
        if kind == "send_mr":
            return [V.SendWR(wr_id=i, mr=loc, offsets=[i], inline=False,
                             signaled=False) for i in range(n)]
        if kind in ("send_inline", "send_laps"):
            k = n if kind == "send_inline" else 2 * n
            return [V.SendWR(wr_id=i, payload=small[i % n], signaled=False)
                    for i in range(k)]
        wrs = []                        # mixed
        for i in range(S.mixed):
            j = i % n
            if i % 5 == 0:
                wrs.append(V.SendWR(wr_id=i, opcode=W, remote_key=blk.rkey,
                                    remote_offsets=offs[j:j + 1],
                                    payload=-pay[j:j + 1]))
            elif i % 5 == 1:
                wrs.append(V.SendWR(wr_id=i, opcode=R, remote_key=blk.rkey,
                                    remote_offsets=offs[j:j + 1],
                                    mr=loc, offsets=[j]))
            elif i % 5 == 2:
                wrs.append(V.SendWR(wr_id=i, mr=loc, offsets=[j],
                                    inline=False))
            elif i % 10 == 3:
                wrs.append(V.SendWR(wr_id=i, opcode=W, remote_key=0xDEAD,
                                    remote_offsets=[0],
                                    payload=pay[j:j + 1]))
            elif i % 20 == 8:           # a READ before the MR
                wrs.append(V.SendWR(wr_id=i, opcode=R, remote_key=blk.rkey,
                                    remote_offsets=[-1]))
            elif i % 20 == 18:          # a WRITE one record past the MR
                wrs.append(V.SendWR(wr_id=i, opcode=W, remote_key=blk.rkey,
                                    remote_offsets=[S.blocks],
                                    payload=pay[j:j + 1]))
            else:
                wrs.append(V.SendWR(wr_id=i, payload=small[j]))
        return wrs

    def drain(self) -> list:
        out = []
        for q in (self.ccq, self.rcq):
            while True:
                got = q.poll()
                if not got:
                    break
                out += got
        return out


def _stream(torch, np, to_host, wcs) -> tuple:
    """A CQE stream as (metadata rows, every data payload flattened)."""
    meta = [(w.wr_id, w.opcode, w.status, w.length,
             None if w.data is None else tuple(w.data.shape)) for w in wcs]
    datas = [w.data for w in wcs if w.data is not None]
    if not datas:
        return meta, np.zeros(0)
    if all(isinstance(d, torch.Tensor) for d in datas):
        flat = torch.cat([d.reshape(-1) for d in datas]).cpu().numpy()
    else:
        flat = np.concatenate([np.asarray(to_host(d)).reshape(-1)
                               for d in datas])
    return meta, flat


def phase_datapath(torch, np, dev, S, rng, T):
    from repro_torch import verbs as V
    from repro_torch.convert import regions_from_numpy, to_host
    from repro_torch.kernels import _build
    from repro_torch.obs import metrics

    t0 = time.perf_counter()
    blocks = np.empty((S.blocks, S.rec), np.float32)
    rng.random(out=blocks, dtype=np.float32)
    local = rng.random((S.n, S.rec), dtype=np.float32)
    offs = rng.choice(S.blocks, size=S.n, replace=False)
    hi = offs >= (1 << 31) // S.rec
    check(hi.any(), "no WRITE lands past element 2^31")
    D = dict(offs=offs,
             payload=rng.random((S.n, S.rec), dtype=np.float32),
             small=rng.integers(-2**31, 2**31 - 1, (S.n, 8),
                                dtype=np.int32))
    data = {"blocks": blocks, "local": local}
    vec = Rig(V, regions_from_numpy, True, data, S)
    orc = Rig(V, regions_from_numpy, False, data, S)
    del data, blocks
    T.sync()
    log(f"phase 3: two rigs seeded ({S.blocks * S.rec * 4 / 2**30:.1f} GiB "
        f"block MR each) in {time.perf_counter() - t0:.1f} s")

    fused = metrics.get_registry().scope("fused")
    launches, ring_l = fused.counter("launches"), fused.counter("ring_launches")
    plan = [("write", 0), ("read", 0), ("read_land", 0), ("send_mr", S.n),
            ("send_inline", S.n), ("send_laps", 2 * S.n),
            ("mixed", S.mixed // 10), ("mixed_retry", S.mixed)]
    lpf = {}
    access_errs = 0
    _build.reset_launches()             # the main path's launches from here
    for kind, recvs in plan:
        res = {}
        for rig in (vec, orc):
            kb = dict(_build.LAUNCHES)
            rig.srq.post_recv([V.RecvWR(wr_id=10_000 + k)
                               for k in range(recvs)])
            c0 = rig.counters()
            if kind != "mixed_retry":
                rig.client.post_send(rig.chain(kind, D, S))
            l0 = launches.value
            processed = rig.client.flush()
            dl = launches.value - l0
            r0 = ring_l.value
            first = rig.rcq.poll()          # one fused poll
            dr = ring_l.value - r0
            wcs = rig.drain() + first
            T.sync()
            res[rig.vec] = (processed, len(rig.client.sq),
                            {k: v - c0[k] for k, v in rig.counters().items()},
                            _stream(torch, np, to_host, wcs), dl, dr,
                            len(first))
            if not rig.vec:
                check(_build.LAUNCHES == kb,
                      f"{kind}: the scalar oracle launched a kernel")
        a, b = res[True], res[False]
        check(a[:3] == b[:3], f"{kind}: processed/stalled/counters differ "
              f"{a[:3]} vs {b[:3]}")
        check(a[3][0] == b[3][0], f"{kind}: CQE streams differ")
        check(np.array_equal(a[3][1], b[3][1]), f"{kind}: CQE data differ")
        lpf[kind] = a[4]
        access_errs += sum(w[2] == V.IBV_WC_ACCESS_ERR for w in a[3][0])
        if kind in ("send_mr", "send_inline"):
            check(a[5] == 1 and a[6] == S.n,
                  f"{kind}: fused poll took {a[5]} ring launches for "
                  f"{a[6]} CQEs")
        log(f"phase 3: {kind:<12} processed {a[0]} stalled {a[1]} "
            f"launches/flush {a[4]} ring launches in first poll {a[5]} "
            f"counters {a[2]}: matches oracle")
        if kind == "write":
            blk = vec.pd.mr_array(vec.mrs["blocks"])
            sel = torch.from_numpy(offs[hi]).to(dev)
            want = torch.from_numpy(D["payload"][hi]).to(dev)
            check(torch.equal(blk[sel], want),
                  "WRITEs past element 2^31 did not land")
        if kind == "read_land":
            check(torch.equal(vec.pd.mr_array(vec.mrs["local"]),
                              torch.from_numpy(D["payload"]).to(dev)),
                  "READs did not land the written records")
    check(res[True][1] == 0, "mixed chain still stalled after the retry")
    # bad rkeys and out-of-range records complete with an error, alone
    check(access_errs == sum(i % 10 == 3 or i % 20 in (8, 18)
                             for i in range(S.mixed)),
          f"{access_errs} ACCESS_ERR completions in the mixed chain")
    main_launches = dict(_build.LAUNCHES)
    for name in ("blocks", "local"):
        check(torch.equal(vec.pd.mr_array(vec.mrs[name]),
                          orc.pd.mr_array(orc.mrs[name])),
              f"MR {name} differs from the oracle")
    check(lpf["write"] == lpf["read"] == lpf["send_mr"] == 1
          and lpf["send_inline"] == lpf["send_laps"] == 0
          and lpf["read_land"] == 2,
          f"launches per flush {lpf}")
    for fn in ("scatter_rows", "gather_rows", "ring_produce",
               "ring_consume", "ring_produce_consume"):
        check(main_launches.get(fn, 0) > 0,
              f"{fn} never launched on the main path")
    log(f"phase 3: MR contents equal; launches per flush {lpf}; main-path "
        f"kernel launches {main_launches}")
    del orc
    torch.cuda.empty_cache()
    return vec, D, lpf, main_launches


# -- phase 4 ----------------------------------------------------------------------
def phase_timing(torch, np, dev, S, T, vec, D):
    from repro_torch import verbs as V
    out = {}
    for kind, recvs, nbytes in (("write", 0, S.n * S.rec * 4),
                                ("read", 0, S.n * S.rec * 4),
                                ("read_land", 0, S.n * S.rec * 4),
                                ("send_mr", S.n, S.n * S.rec * 4),
                                ("send_inline", S.n, S.n * 32)):
        post, flush, poll = [], [], []
        for _ in range(S.reps):
            vec.srq.post_recv([V.RecvWR(wr_id=k) for k in range(recvs)])
            wrs = vec.chain(kind, D, S)
            T.sync()
            t0 = time.perf_counter()
            vec.client.post_send(wrs)
            t1 = time.perf_counter()
            vec.client.flush()
            T.sync()
            t2 = time.perf_counter()
            vec.drain()
            T.sync()
            t3 = time.perf_counter()
            post.append(t1 - t0)
            flush.append(t2 - t1)
            poll.append(t3 - t2)
        f = statistics.median(flush)
        total = statistics.median(p + q + r
                                  for p, q, r in zip(post, flush, poll))
        out[kind] = dict(us_per_flush=f * 1e6, wrs_per_s=S.n / total,
                         payload_gb_per_s=nbytes / f / 1e9,
                         post_us=statistics.median(post) * 1e6,
                         poll_us=statistics.median(poll) * 1e6)
        log(f"phase 4: {kind:<12} {f * 1e6:.1f} us/flush  "
            f"{S.n / total:.0f} WRs/s  {nbytes / f / 1e9:.3f} GB/s payload "
            f"(post {out[kind]['post_us']:.0f} us, poll "
            f"{out[kind]['poll_us']:.0f} us; median of {S.reps})")
    host = D["payload"]
    h2d = [T.ms(lambda: torch.from_numpy(host).to(dev), iters=1, warmup=1)
           for _ in range(S.reps)]
    out["h2d_stage_ms"] = statistics.median(h2d)
    log(f"phase 4: host->device staging of one WRITE run "
        f"({host.nbytes / 2**20:.0f} MiB, pageable): "
        f"{out['h2d_stage_ms']:.3f} ms (median of {S.reps})")
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import device as tdevice
    from repro_torch.kernels import _build

    S = FULL
    dev = tdevice.resolve("cuda")
    tdevice.set_default(dev)
    rng = np.random.default_rng(0)
    T = Timer(torch)
    t_start = time.perf_counter()

    # phase 1: the card and the build
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build()
    log(f"phase 1: built {len(_build.SOURCES)} kernel sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in _build.LOGS.items():
        for line in dict.fromkeys(text.splitlines()):     # one per kind
            if "registers" in line or "spill" in line:
                log(f"phase 1: {name}: {line.strip()}")

    rows = phase_kernels(torch, np, dev, S, rng, T)
    vec, D, lpf, main_launches = phase_datapath(torch, np, dev, S, rng, T)
    timing = phase_timing(torch, np, dev, S, T, vec, D)

    kernels = []
    for fn, r in rows.items():
        r = dict(r, launches=main_launches.get(
            {"wr_scatter": "scatter_rows",
             "wr_gather": "gather_rows"}.get(fn, fn), 0))
        kernels.append(r)
    log(json.dumps({"chains": timing, "launches_per_flush": lpf,
                    "seconds": time.perf_counter() - t_start}))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
