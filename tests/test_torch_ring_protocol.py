"""A model of the per-rank ring's flag protocol (``csrc/ring.cu``, the rank
mode, ``ternary_ring_rank``), run in random interleavings on the CPU.

Each of d ranks makes 3 calls in a row, as a process makes them on one
stream: a call's B blocks start together (the launch is cooperative) once
the rank's previous call has ended, and B may differ from call to call (a
communicator serves any shard width). Each block is two generators, its
compute warps (thread 0 among them) and its copy warps, that meet at the
block's barriers as ``ring_body`` does; every wait yields until its
counter reaches its target, compared modulo 2**32. The targets are the
kernel's: ``B * ((t + 1) / 2)`` within a call, offset by the epoch (the
blocks a rank of the earlier calls, ``RingComm.epoch``) times what a call
adds to the counter a block (``call_adds``, ``csrc/ring.cu``); the
counters may start anywhere, so that a wrap shows. Every call multiplies a
fresh X, so a slot read early holds the wrong data.

``hypothesis`` picks the interleavings. The model fails if a slot is
overwritten while a block still reads it (before its ack), if a block reads
a slot before the chunk it expects has fully arrived (before its recv), if
no generator can move (where the kernel would spin until it traps), or if
any rank's Y columns differ from the plain version's. This is where a wrong
epoch offset or ack target shows without a card; the card's tests hold the
kernel itself (``tests/test_torch_cuda.py -k ring``, ``chip_smoke.py``
phase 11b).
"""

import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ternary_spgemm_tpu_torch.formats import DenseTernary
from ternary_spgemm_tpu_torch.parallel.ring_kernel import (
    FLAGS_PER_RANK,
    ring_allgather_spgemm_plain,
)

READY, RECV, ACK = 0, 1, 3
CALLS, MC, K, NL = 3, 8, 3, 2


class Violation(AssertionError):
    pass


def reached(v: int, target: int) -> bool:
    return (v - target) % 2 ** 32 < 2 ** 31


def call_adds(d: int) -> tuple:
    """``csrc/ring.cu``'s ``call_adds``: what one call adds, a block of the
    rank, to (ready, recv[0], recv[1], ack[0], ack[1])."""
    return (1, (d - 1) // 2, d // 2, (d - 1) // 2 if d > 1 else 0,
            (d - 2) // 2 if d > 2 else 0)


class Model:
    """The shared memory of a ring of ``d`` ranks (flag blocks and chunk
    slots) and the generators of its blocks, ``Bs[c]`` a rank in call
    ``c``."""

    def __init__(self, d: int, Bs, start: int, adds=call_adds,
                 epoch=lambda Bs, call: sum(Bs[:call])):
        self.d, self.Bs, self.start, self.adds = d, tuple(Bs), start, adds
        self.epoch = epoch
        data = np.random.default_rng(d * 10 + sum(self.Bs))
        self.X = [data.integers(-9, 10, (d * MC, K)).astype(np.float32)
                  for _ in range(CALLS)]
        self.W = data.integers(-1, 2, (K, d * NL)).astype(np.int8)
        self.b = data.integers(-4, 5, d * NL).astype(np.float32)
        self.flags = [[start] * FLAGS_PER_RANK for _ in range(d)]
        self.slots = [np.zeros((2, MC * K), np.float32) for _ in range(d)]
        #: (rank, slot) -> the slices of it that blocks are reading now
        self.reading = {(r, s): [] for r in range(d) for s in (0, 1)}
        self.Y = [[np.zeros((d * MC, NL), np.float32) for _ in range(d)]
                  for _ in range(CALLS)]

    def slice(self, bi: int, B: int) -> slice:
        n = MC * K
        return slice(n * bi // B, n * (bi + 1) // B)

    def base(self, call: int, i: int) -> int:
        """Counter ``i``'s value when ``call`` starts, as the kernel
        reckons it: where the counters started plus the epoch (the blocks
        a rank of the earlier calls) times what a call adds a block."""
        epoch = self.epoch(self.Bs, call)
        return (self.start + epoch * self.adds(self.d)[i]) % 2 ** 32

    def add(self, rank: int, i: int) -> None:
        self.flags[rank][i] = (self.flags[rank][i] + 1) % 2 ** 32

    def until(self, rank: int, i: int, target: int):
        return lambda: reached(self.flags[rank][i], target)

    def write(self, rank: int, s: int, sl: slice, values) -> None:
        for lo, hi in self.reading[rank, s]:
            if lo < sl.stop and sl.start < hi:
                raise Violation(f"slot {s} of rank {rank} overwritten while "
                                f"a block reads it (before its ack)")
        self.slots[rank][s][sl] = values

    def chunk(self, call: int, owner: int):
        return self.X[call][owner * MC:(owner + 1) * MC].ravel()

    def block(self, call: int, r: int, bi: int):
        """The two generators of block ``bi`` of rank ``r`` in ``call``."""
        d, B = self.d, self.Bs[call]
        left, right = (r - 1) % d, (r + 1) % d
        mine = self.slice(bi, B)
        arrived = [0]

        def sync(n):
            # the block's n-th barrier, between its two roles
            arrived[0] += 1
            yield lambda: arrived[0] >= 2 * n

        def compute():
            n = 0
            self.write(r, 0, mine, self.chunk(call, r)[mine])
            n += 1
            yield from sync(n)
            self.add(r, READY)
            for p in (r, left, right):
                yield self.until(p, READY, self.base(call, READY) + B)
            n += 1
            yield from sync(n)
            for t in range(d):
                slot = t % 2
                if t >= 1:
                    yield self.until(r, RECV + slot, self.base(
                        call, RECV + slot) + B * ((t + 1) // 2))
                    n += 1
                    yield from sync(n)
                whole = (0, MC * K)
                self.reading[r, slot].append(whole)
                held = self.slots[r][slot].copy()
                yield None
                owner = (r - t) % d
                if not (np.array_equal(held, self.chunk(call, owner)) and
                        np.array_equal(self.slots[r][slot], held)):
                    raise Violation(f"rank {r} step {t} of call {call} read "
                                    f"slot {slot} before its recv")
                cols = slice(r * NL, (r + 1) * NL)
                self.Y[call][r][owner * MC:(owner + 1) * MC] = (
                    held.reshape(MC, K) @ self.W[:, cols] + self.b[cols])
                self.reading[r, slot].remove(whole)
                n += 1
                yield from sync(n)
                if t <= d - 3:
                    self.add(r, ACK + slot)

        def copy():
            n = 1
            yield from sync(n)
            n += 1
            yield from sync(n)
            for t in range(d):
                slot, nxt = t % 2, (t + 1) % 2
                if t >= 1:
                    n += 1
                    yield from sync(n)
                if t < d - 1:
                    if t >= 1:
                        yield self.until(right, ACK + nxt, self.base(
                            call, ACK + nxt) + B * ((t + 1) // 2))
                    span = (mine.start, mine.stop)
                    self.reading[r, slot].append(span)
                    yield None
                    self.write(right, nxt, mine, self.slots[r][slot][mine])
                    self.reading[r, slot].remove(span)
                    yield None
                    self.add(right, RECV + nxt)
                n += 1
                yield from sync(n)

        return [compute(), copy()]

    def run(self, pick) -> None:
        """Every rank's calls to their end; ``pick`` chooses the next
        generator to move among those that can, (rank, generator) pairs."""
        calls = [0] * self.d
        live = {r: self.block_set(0, r) for r in range(self.d)}
        while live:
            ready = [(r, g) for r, gens in live.items()
                     for g, wait in gens.items() if wait is None or wait()]
            if not ready:
                raise Violation(f"no block can move: ranks at calls {calls} "
                                f"(the kernel's spins would trap)")
            r, g = pick(ready)
            try:
                live[r][g] = next(g)
            except StopIteration:
                del live[r][g]
                if not live[r]:
                    calls[r] += 1
                    if calls[r] < CALLS:
                        live[r] = self.block_set(calls[r], r)
                    else:
                        del live[r]

    def block_set(self, call: int, r: int) -> dict:
        return {g: None for bi in range(self.Bs[call])
                for g in self.block(call, r, bi)}

    def check_y(self) -> None:
        fmt = DenseTernary.from_dense(self.W)
        for call in range(CALLS):
            want = ring_allgather_spgemm_plain(
                torch.from_numpy(self.X[call]), fmt, torch.from_numpy(self.b),
                ranks=self.d).numpy()
            for r in range(self.d):
                got = self.Y[call][r]
                assert np.array_equal(got, want[:, r * NL:(r + 1) * NL]), \
                    f"call {call} rank {r}: Y differs from the plain version"


def at_random(rnd: random.Random):
    return lambda ready: ready[rnd.randrange(len(ready))]


class InTurn:
    """One rank at a time, as a card time-slices processes: a rank moves
    until it must wait, then the next rank that can."""

    def __init__(self, d: int):
        self.d, self.turn = d, 0

    def __call__(self, ready):
        for k in range(self.d):
            r = (self.turn + k) % self.d
            mine = [x for x in ready if x[0] == r]
            if mine:
                self.turn = r
                return mine[0]


@settings(max_examples=60, deadline=None, derandomize=True)
@given(d=st.integers(1, 5),
       Bs=st.lists(st.integers(1, 3), min_size=CALLS, max_size=CALLS),
       start=st.sampled_from([0, 2 ** 32 - 7]),
       rnd=st.randoms(use_true_random=False))
def test_protocol_holds_in_any_interleaving(d, Bs, start, rnd):
    model = Model(d, Bs, start)
    model.run(at_random(rnd))
    model.check_y()


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5])
def test_protocol_holds_when_ranks_run_in_turn(d):
    model = Model(d, (2, 1, 3), 2 ** 32 - 7)
    model.run(InTurn(d))
    model.check_y()


@pytest.mark.parametrize("d", range(1, 10))
def test_call_adds_count_the_schedule(d):
    """``call_adds`` is what the schedule adds: after the model's 3 calls
    every rank's counters have grown by the epoch (the blocks a rank of
    all 3 calls) times ``call_adds`` -- one ready a block, the left
    neighbour's copy at every step t <= d - 2 into slot (t + 1) % 2, an ack
    of slot t % 2 at every step t <= d - 3."""
    model = Model(d, (2, 1, 3), 2 ** 32 - 7)
    model.run(InTurn(d))
    for r in range(d):
        grown = [(v - model.start) % 2 ** 32 for v in model.flags[r]]
        assert grown == [6 * n for n in call_adds(d)], f"rank {r}"


@pytest.mark.parametrize("name,adds", [
    ("no epoch offsets", lambda d: (0,) * FLAGS_PER_RANK),
    ("recv slots swapped", lambda d: (1, d // 2, (d - 1) // 2,
                                      *call_adds(d)[3:])),
    ("ack one short", lambda d: (*call_adds(d)[:3], 0, 0)),
])
def test_model_catches_a_wrong_offset(name, adds):
    """The model has teeth: with a wrong offset some interleaving reads a
    slot early, overwrites one before its ack, or stalls."""
    caught = 0
    for seed in range(40):
        model = Model(4, (2, 2, 2), 0, adds=adds)
        try:
            model.run(at_random(random.Random(seed)))
            model.check_y()
        except AssertionError:
            caught += 1
    assert caught, f"{name}: no interleaving of 40 showed the fault"


def test_model_catches_an_epoch_of_calls_times_blocks():
    """An epoch of the call's index times its own B, where B changed from
    an earlier call, puts the targets too low: some interleaving reads a
    slot early or overwrites one before its ack. Hence the epoch sums the
    blocks that each earlier call launched."""
    caught = 0
    for seed in range(40):
        model = Model(4, (3, 1, 3), 0,
                      epoch=lambda Bs, call: call * Bs[call])
        try:
            model.run(at_random(random.Random(seed)))
            model.check_y()
        except AssertionError:
            caught += 1
    assert caught, "no interleaving of 40 showed the fault"
