"""Bitmap rollups while logins come in: daily-active bitmaps, a login
stream that sets bits in today's, and clients that each ask for the
actives over the month that ends today.

Set-up makes `days` - 1 past days of 2^id_bits bits and today's bitmap,
holding the day so far, through the facade's own SETBIT path
(`RBitSet.set_bits`), from ids drawn on the card from the seed. From the
loop's start a login writer sends a batch of `login_batch` ids to set in
today's bitmap every `login_every_ms` (`set_bits_async`, at a fixed rate,
not waiting for the ones before), while each client, on its own
destination, asks Redisson's `dest.or_(days)` over the latest
`window_days` days, which ORs them into the destination (`BITOP OR dest
dest day..`), then `dest.cardinality()`.
Today grows between queries, so each query's OR has new bits to take.

Judged once the loop has drained. The logins are one ordered stream (one
writer, one object's queue, applied in order), so
after k batches the month's union is a known set with a known count c_k.
A query may have seen any k from the batches acknowledged before it was
sent to those sent before it returned; its count has to be one of those
c_k exactly. Each destination's cells are compared with the union at the
k its last count names.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np

from gridbench.harness import program
from gridbench.reference import bitmaps as ref
from gridbench.work import bitop_count

#: seconds of login batches made beyond the warm-up and the window, for
#: the drain
SPARE_S = 30.0


class Driver:
    unit = "queries"

    def __init__(self, cfg: dict, mix: dict, seed: int, cards: List[str],
                 seconds: float = 0.0):
        self.cfg, self.seed, self.cards = cfg, seed, cards
        self.nbits = 1 << int(cfg["id_bits"])
        self.days = int(cfg["days"])
        self.width = int(mix["window_days"])
        if not 1 <= self.width <= self.days:
            raise ValueError("window_days must lie in [1, days]")
        self.clients = int(mix["clients"])
        self.depth = 1
        self.login_batch = int(mix["login_batch"])
        self.login_every = float(mix["login_every_ms"]) / 1e3
        self.today_at_start = int(mix["today_setbits_at_start"])
        self.n_batches = 1 + int((float(mix["warm_seconds"]) + seconds + SPARE_S)
                                 / self.login_every)
        self.day_ids: List[np.ndarray] = []
        self.logins: np.ndarray = np.zeros((0, 0), np.int64)
        self.writes: List[list] = []  # [t_submit, t_done, future] in order
        self.client = None

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        import torch

        self.client = program.make_client(self.cfg, self.cards[0])
        gen = torch.Generator(device=self.cards[0]).manual_seed(self.seed)
        sizes = [int(self.cfg["setbits_per_day"])] * (self.days - 1)
        sizes.append(self.today_at_start)
        pending = []
        for d, n in enumerate(sizes):
            ids = torch.randint(0, self.nbits, (n,), generator=gen,
                                device=self.cards[0])
            self.day_ids.append(ids.cpu().numpy())
            pending.append(self._day(d).set_bits_async(self.day_ids[-1]))
        for f in pending:
            f.result()
        self.logins = torch.randint(0, self.nbits, (self.n_batches, self.login_batch),
                                    generator=gen, device=self.cards[0]).cpu().numpy()
        self.today = self._day(self.days - 1)
        self.day_names = [self._day(d).get_name() for d in range(self.days)]
        self.dests = [self.client.get_bit_set(f"mau:client{c}")
                      for c in range(self.clients)]
        # every shape of the traffic before the loop: a login batch (the
        # stream's first, counted as today's) and each client's query
        self.today.set_bits(self.logins[0])
        for c in range(self.clients):
            self.start(c, -1)

    def _day(self, d: int):
        return self.client.get_bit_set(f"dau:day{d:03d}")

    # -- the loop -------------------------------------------------------------

    def side(self, stop) -> None:
        """The login writer, open loop: batch k (from 1) is sent k - 1
        periods after the loop's start, whether or not the ones before it
        have been acknowledged; each one's acknowledgement is stamped."""
        due = time.perf_counter()
        for k in range(1, self.n_batches):
            wait = due - time.perf_counter()
            if wait > 0 and stop.wait(wait):
                return
            if stop.is_set():
                return
            entry = [time.perf_counter(), None, None]
            entry[2] = self.today.set_bits_async(self.logins[k])
            entry[2].add_done_callback(
                lambda _f, e=entry: e.__setitem__(1, time.perf_counter()))
            self.writes.append(entry)
            due += self.login_every

    def start(self, c: int, seq: int):
        dest = self.dests[c]
        dest.or_(*self.day_names[self.days - self.width:])
        return dest.cardinality(), 1, None

    def stage_totals(self):
        return program.stage_totals(self.client)

    def work_bytes(self, calls) -> Dict[str, int]:
        # the destination is an operand too
        per = bitop_count.least_bytes([self.nbits] * (self.width + 1), self.nbits)
        return {"bitop_count": per * len(calls)}

    # -- after the window -----------------------------------------------------

    def outputs(self, calls) -> dict:
        self.write_errors = []
        for w in self.writes:
            try:
                w[2].result()
                self.write_errors.append(None)
            except Exception as exc:  # noqa: BLE001 - counted as failed
                self.write_errors.append(exc)
            if w[1] is None:  # its stamp may still be on its way: later is safe
                w[1] = time.perf_counter()
            w[2] = None
        last = {}
        for call in calls:
            if call.error is None:
                last[call.client] = call
        cells = {}
        for c, call in last.items():
            got = program.export(self.client, self.dests[c].get_name(),
                                 "bits_export")
            cells[c] = (call, np.zeros((0,), np.uint8) if got is None else got[1])
        return {"cells": cells}

    def release(self) -> int:
        """Shut the program down and drop every object of it; the bytes
        it still holds on the cards."""
        self.client.shutdown()
        self.client = self.dests = self.today = None
        return program.free_memory(self.cards)

    def _seen(self, call, n: int) -> tuple:
        """(lo, hi): the login batches a query may have seen, as counts
        of the stream's batches after the first: from those all
        acknowledged before it was sent to those sent before it returned,
        at most the `n` the reference follows."""
        lo = min(int(np.searchsorted(self._acked, call.t_submit)), n)
        return lo, max(lo, min(int(np.searchsorted(self._sent, call.t_done)), n))

    def check(self, calls, outputs, control: bool = False) -> dict:
        """The numbers compared, each with its limit. With `control` the
        reference stands in for the program's answers with a stale read:
        the count before the newest acknowledged login batch (a read that
        misses the latest acknowledged write)."""
        import torch

        dev = torch.device(self.cards[0])
        s = self.days - self.width
        cells = ref.union_cells(self.day_ids[s:] + [self.logins[0]], self.nbits, dev)
        self._acked = np.maximum.accumulate(
            np.array([w[1] for w in self.writes], np.float64))
        self._sent = np.array([w[0] for w in self.writes], np.float64)
        errs = self.write_errors
        failed = [i for i, e in enumerate(errs) if e is not None]
        n_writes = failed[0] if failed else len(errs)
        print(f"gridbench: {len(errs)} login batches sent, {n_writes} followed",
              file=sys.stderr)
        # batches the reference follows: every one acknowledged
        batches = [self.logins[k] for k in range(1, n_writes + 1)]
        ends = {}  # k -> clients whose destination holds the union at k
        gap, wrong = 0, 0
        base = cells.clone()
        counts = ref.prefix_counts(cells, batches)
        del cells
        for call in calls:
            if call.error is not None:
                continue
            lo, hi = self._seen(call, n_writes)
            allowed = counts[lo:hi + 1]
            got = int(counts[max(lo - 1, 0)]) if control else int(call.result)
            g = int(np.min(np.abs(allowed - got)))
            gap, wrong = max(gap, g), wrong + (g != 0)
        for c, (call, got) in outputs["cells"].items():
            lo, hi = self._seen(call, n_writes)
            hits = np.nonzero(counts[lo:hi + 1] == int(call.result))[0]
            ends.setdefault(lo + int(hits[0]) if hits.size else hi, []).append(got)
        cells_wrong, k = 0, 0
        for end in sorted(ends):
            for ids in batches[k:end]:
                ref.add(base, ids)
            k = end
            for got in ends[end]:
                cells_wrong += ref.cells_differing(base, got)
        del base
        return {
            "calls_failed": (sum(c.error is not None for c in calls), 0),
            "logins_failed": (sum(e is not None for e in errs), 0),
            "count_gap": (gap, 0),
            "counts_wrong": (wrong, 0),
            "cells_wrong": (cells_wrong, 0),
        }
