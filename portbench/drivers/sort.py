"""Cells of the SIM sort: closed-loop ``repro_torch.sort.sort`` calls on
host batches of banks, each call waited for, as a researcher calls it.

Timed path: ``sort(x, engine=<cfg engine>, k=<cfg k>)`` on a (banks, N)
numpy batch of unsigned keys, cycling through a pool made from the seed
in set-up.  ``sort_keys_per_s`` is every key of every completed call over
the window.  The check samples banks of the window's calls, drawn from
the seed, and holds their values, indices, cycles, digit reads and
reload cycles to the plain reference (``reference/tns.py``): exact.
"""
from __future__ import annotations

import time

import numpy as np

from portbench import gen
from portbench.reference import tns as ref

FIELDS = ("indices", "values", "cycles", "drs", "reload_cycles")
KEEP_TABLE = 4096       # calls whose kept banks are drawn in set-up


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans):
        if cfg["key_format"] != "unsigned" or cfg["order"] != "ascending":
            raise ValueError("the sort driver runs unsigned keys ascending")
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.spans = device, spans
        self.width, self.k = cfg["key_bits"], cfg["lifo_depth_k"]
        self.banks, self.n = mix["banks_per_call"], cfg["keys_per_bank"]
        self.calls = 0
        self.kept = []      # (pool index, banks, the call's answers there)

    def setup(self) -> None:
        t = time.perf_counter()
        from repro_torch import sort
        self.sort = sort.sort
        r = gen.rng(self.seed, 0)
        dt = gen.key_dtype(self.width)
        self.pool = [gen.dataset(self.mix["dataset"], (self.banks, self.n),
                                 self.width, r).astype(dt)
                     for _ in range(self.mix["pool"])]
        # the banks each call keeps for the check, drawn here so that the
        # window does no drawing; calls past the table take it again
        pick = gen.rng(self.seed, 1)
        self.keep = np.stack([pick.choice(self.banks,
                                          self.mix["keep_per_call"],
                                          replace=False)
                              for _ in range(KEEP_TABLE)])
        t1 = time.perf_counter()
        self._call(record=False)            # builds and loads the kernels
        self.phases = {"imports and pool": t1 - t,
                       "first call": time.perf_counter() - t1}

    def _call(self, record: bool = True):
        i = self.calls % len(self.pool)
        with self.spans("sort"):
            res = self.sort(self.pool[i], engine=self.cfg["engine"],
                            k=self.k, device=self.device)
        if record:
            bs = self.keep[self.calls % KEEP_TABLE]
            self.kept.append((i, bs, {f: np.asarray(getattr(res, f))[bs]
                                      for f in FIELDS}))
            self.calls += 1
        return res

    # -- the harness's loop --------------------------------------------------
    def begin_window(self) -> None:
        self.window_calls = self.calls

    def unit(self) -> None:
        self._call()

    def metrics(self, window_s: float) -> dict:
        calls = self.calls - self.window_calls
        self.attempted = calls
        return {"sort_keys_per_s": calls * self.banks * self.n / window_s}

    def trace_counters(self, units: int) -> dict:
        return {"calls": units, "banks": self.banks, "n": self.n,
                "width": self.width}

    def free(self) -> None:
        pass

    # -- correctness ---------------------------------------------------------
    def check(self, control: bool = False) -> dict:
        """Mismatches against the reference over a seeded sample of the
        kept banks: each field's count of banks that differ.  With
        ``control``, the sampled answers are the control's instead of the
        program's: the reference on keys one bit narrower (the low digit
        plane dropped), a break of the configuration's exact order."""
        kept = [(i, int(b), {f: v[j] for f, v in got.items()})
                for i, bs, got in self.kept for j, b in enumerate(bs)]
        r = gen.rng(self.seed, 2)
        m = min(self.mix["check_banks"], len(kept))
        sample = [kept[j] for j in sorted(r.choice(len(kept), m,
                                                   replace=False))]
        bad = {f: 0 for f in FIELDS}
        self.failed = 0
        for i, b, got in sample:
            want = ref.sort_banks(self.pool[i], self.width, self.k, [b])
            if control:
                x = self.pool[i]
                c = ref.sort_banks(x >> 1, self.width - 1, self.k, [b])
                got = {f: v[0] for f, v in c.items()}
                got["values"] = x[b][c["indices"][0]]
            wrong = [f for f in bad if not np.array_equal(
                np.asarray(want[f][0]), np.asarray(got[f]))]
            for f in wrong:
                bad[f] += 1
            self.failed += bool(wrong)
        out = {f"banks_wrong_{f}": (v, 0) for f, v in bad.items()}
        # fewer banks than the mix asks for would leave the check short
        out["banks_unchecked"] = (self.mix["check_banks"] - m, 0)
        return out
