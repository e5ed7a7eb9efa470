"""Cells of a served language model: the port's serving steps
(``repro_torch.launch.steps.make_prefill_step`` / ``make_decode_step``)
over weights the benchmark makes on the device from the seed, in the
port's parameter layout, in the configuration's dtype.

Two traffic kinds:

* ``decode``: ``rows`` sequences, each a ``prompt_len`` prompt prefilled
  into the cache in set-up (``prefill_rows`` rows a call), then decoded
  continuously.  A row's answers take their lengths from ``answer_lens``
  in a seeded cycle; a row that finishes one rewinds to its prompt's end
  and starts another on the same context from the same first token, so
  the cache stays at ``prompt_len + max(answer_lens)`` whatever the
  window's length.  ``decode_tok_per_s``: every row's token of every step
  over the window (host clock, ending in a synchronise).  ``itl_p95_ms``:
  the 95th percentile of the gaps between the steps' CUDA events.
* ``prefill``: closed-loop rounds, each a batch of ``prompts_per_round``
  fresh prompts of one length (``lengths`` cycle, whatever the seed; the
  seed draws the tokens), prefilled, then one token sampled and copied to
  the host.  ``ttft_p95_ms``: the 95th percentile over the window's
  rounds, each from a CUDA event recorded before the prompt leaves the
  host to one recorded once the token is back on it.

Tokens are drawn with top-k sampling through the port's
``sampling.sample_logits`` (``topk_mask``), except for the seeded
``greedy_share`` of the rows, which take the argmax.  The check runs the
plain float32 reference (``reference/<cfg reference>.py``) over finished
answers, greedy and sampled, from both halves of the rows (decode), or
over rounds (prefill), drawn from the seed with the longest among them.
A greedy token is judged by how far the reference's logit of it lies
below the reference's best, a sampled one by how far it lies below the
reference's ``top_k``-th best; the mean over the checked positions of
each kind is held to the mix's limit.
"""
from __future__ import annotations

import importlib
import math
import time

import numpy as np
import torch

from portbench import accounting, gen

MAX_STEPS = 40000        # decode steps a run may take (trace and window)


def p95(values) -> float:
    """Nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def arch_config(cfg: dict):
    """The port's ArchConfig of a configuration file."""
    from repro_torch.models.config import ArchConfig
    port = cfg["port"]
    dt = cfg["torch_dtype"]
    return ArchConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], vocab=cfg["vocab_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        rope_theta=cfg["rope_theta"],
        d_ff=cfg["shared_expert_intermediate_size"], moe=True,
        n_routed_experts=cfg["num_experts"],
        n_shared_experts=(cfg["shared_expert_intermediate_size"]
                          // cfg["moe_intermediate_size"]),
        moe_top_k=cfg["num_experts_per_tok"],
        d_ff_expert=cfg["moe_intermediate_size"], moe_layer_start=0,
        moe_capacity_factor=port["moe_capacity_factor"],
        router_impl=port["router_impl"], attn_impl=port["attn_impl"],
        param_dtype=dt, compute_dtype=dt)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The benchmark's weights, one draw a stacked leaf from one generator
    on the device, in the served dtype (the router in float32): normal
    with scale 1/sqrt(fan-in), the token embedding 0.02, norms 1."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    E, ff = cfg["num_experts"], cfg["moe_intermediate_size"]
    sff, V = cfg["shared_expert_intermediate_size"], cfg["vocab_size"]
    dt = getattr(torch, cfg["torch_dtype"])
    g = torch.Generator(device=device)
    g.manual_seed(seed & (2 ** 63 - 1))

    def normal(shape, fan_in, dtype=dt, std=None):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, std or fan_in ** -0.5, generator=g)

    ones = lambda *s: torch.ones(s, dtype=dt, device=device)
    return {"tok": normal((V, d), None, std=0.02),
            "head": normal((d, V), d),
            "final_norm": ones(d), "norm1": ones(L, d), "norm2": ones(L, d),
            "wq": normal((L, d, H * hd), d), "wk": normal((L, d, KV * hd), d),
            "wv": normal((L, d, KV * hd), d),
            "wo": normal((L, H * hd, d), H * hd),
            "router": normal((L, d, E), d, dtype=torch.float32),
            "wi": normal((L, E, d, 2 * ff), d), "we": normal((L, E, ff, d), ff),
            "swi": normal((L, d, 2 * sff), d),
            "swo": normal((L, sff, d), sff)}


def port_params(w: dict, arch) -> dict:
    """The same tensors in the port's stacked parameter tree; refused
    unless every leaf's path, shape and dtype is the port's own."""
    from repro_torch import tree
    from repro_torch.models import stacked
    params = {"embed": {"tok": w["tok"], "head": w["head"]},
              "final_norm": {"w": w["final_norm"]},
              "segments": [{
                  "norm1": {"w": w["norm1"]},
                  "attn": {"wq": w["wq"], "wk": w["wk"], "wv": w["wv"],
                           "wo": w["wo"]},
                  "norm2": {"w": w["norm2"]},
                  "moe": {"router": w["router"], "wi": w["wi"],
                          "wo": w["we"],
                          "shared": {"wi": w["swi"], "wo": w["swo"]}}}]}
    want = {p: (tuple(t.shape), t.dtype) for p, t in tree.flatten_with_path(
        stacked.init_params(arch, None, "meta"))}
    got = {p: (tuple(t.shape), t.dtype)
           for p, t in tree.flatten_with_path(params)}
    if want != got:
        raise ValueError(f"the benchmark's weights are not the port's "
                         f"layout: {sorted(set(want.items()) ^ set(got.items()))}")
    return params


def _rows(c, a: int, b: int):
    """Rows a:b of a stacked cache (batch on dim 1): views, so the
    prefill's writes land in the whole cache."""
    if isinstance(c, dict):
        return {k: _rows(v, a, b) for k, v in c.items()}
    if isinstance(c, list):
        return [_rows(v, a, b) for v in c]
    return c[:, a:b]


class Cell:
    """One model cell; set-up makes ``unit`` one decode step or one
    prefill round, by the mix's kind."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.spans = device, spans
        self.cuda = device.type == "cuda"
        self.ref = importlib.import_module(
            f"portbench.reference.{cfg['reference']}")
        self.attempted = self.failed = 0

    # -- shared ------------------------------------------------------------
    def _phase(self, name: str) -> None:
        """Close the set-up phase that ran until now under ``name``."""
        self.sync()
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now

    def setup(self) -> None:
        self.phases, self._t = {}, time.perf_counter()
        from repro_torch.launch import steps
        from repro_torch.models import sampling, stacked
        self.sampling, self.stacked = sampling, stacked
        self.arch = arch_config(self.cfg)
        self._phase("imports")
        self.weights = make_weights(self.cfg, self.seed, self.device)
        self.params = port_params(self.weights, self.arch)
        self._phase("weights")
        self.prefill = steps.make_prefill_step(self.arch)
        self.decode = steps.make_decode_step(self.arch)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed((self.seed + 1) & (2 ** 63 - 1))
        kind = self.mix["kind"]
        if kind == "decode":
            self._setup_decode()
        elif kind == "prefill":
            self._setup_prefill()
        else:
            raise ValueError(f"unknown traffic kind {kind!r}")

    def _greedy(self, n: int) -> torch.Tensor:
        g = np.zeros(n, dtype=bool)
        g[gen.rng(self.seed, 11).permutation(n)[:int(n * self.mix[
            "greedy_share"])]] = True
        return torch.as_tensor(g, device=self.device)

    def _choose(self, lg: torch.Tensor, greedy) -> torch.Tensor:
        """The served token of each row of (B, V) logits: the argmax for
        the greedy rows, a top-k sample for the others (``greedy`` None:
        every row greedy)."""
        first = lg.argmax(dim=-1).to(torch.int32)
        if greedy is None:
            return first
        drawn = self.sampling.sample_logits(lg, self.gen, self.mix["top_k"])
        return torch.where(greedy, first, drawn)

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @staticmethod
    def _ms(a, b) -> float:
        if isinstance(a, float):
            return (b - a) * 1e3
        return a.elapsed_time(b)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def free(self) -> None:
        """Drop the program's state (caches, logits); the weights are the
        benchmark's and stay for the reference."""
        self.cache = self.params = self.decode = self.prefill = None
        if self.cuda:
            torch.cuda.empty_cache()

    def _gaps(self, case, control: bool, gen) -> dict:
        """The reference's gaps (below its k-th best) of one case's tokens:
        under "" the program's chosen tokens, or with ``control`` those the
        control serves there, and then the program's under "program_"."""
        seq, prompt_len, positions, chosen, k = case
        dev = self.device
        toks = torch.as_tensor(seq, device=dev)
        pos = torch.as_tensor(positions, device=dev)
        h = self.ref.hidden(self.weights, self.cfg, toks, prompt_len)[
            pos.long()]
        gap = lambda ch: self.ref.gaps(self.weights, h, torch.as_tensor(
            ch, device=dev), k).cpu().numpy()
        if not control:
            return {"": gap(chosen)}
        c = self.ref.control_choice(self.weights, self.cfg, toks, prompt_len,
                                    pos, k, gen)
        return {"": gap(c), "program_": gap(chosen)}

    def _checks(self, cases, want: int, control: bool) -> dict:
        """cases: (sequence, prompt length, positions, chosen tokens, k).
        Each token is judged by how far the reference's logit of it lies
        below the reference's k-th best: k 1 for a greedy answer
        (``logit_gap_mean``), the mix's ``top_k`` for a sampled one
        (``topk_gap_mean``, where the mix gives it a limit): the mean over
        every checked position of each kind, against the mix's limits
        (PERF.md gives the readings they were set from).  With
        ``control`` the control's tokens stand in the program's place under
        the same names and limits, and the program's readings come beside
        them as ``program_*``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed + 2) & (2 ** 63 - 1))
        names = {1: "logit_gap_mean"}
        if "topk_gap_mean_limit" in self.mix:
            names[self.mix["top_k"]] = "topk_gap_mean"
        per = [(c[4], self._gaps(c, control, gen)) for c in cases]
        out = {}
        self.failed = 0
        for side in ("", "program_") if control else ("",):
            for k, name in names.items():
                limit = self.mix[f"{name}_limit"]
                g = [v[side] for kk, v in per if kk == k]
                mean = float(np.concatenate(g).mean()) if g else float("inf")
                out[side + name] = (mean, limit)
                if side == "":
                    self.failed += sum(float(v.mean()) > limit for v in g)
        out["checked_short"] = (want - len(cases), 0)
        return out

    # -- decode ------------------------------------------------------------
    def _setup_decode(self) -> None:
        mix, dev = self.mix, self.device
        R, P = mix["rows"], mix["prompt_len"]
        lens = mix["answer_lens"]
        self.cache = self.stacked.init_cache(self.arch, R, P + max(lens), dev)
        self.prompts = gen.prompts(gen.rng(self.seed, 10),
                                   self.cfg["vocab_size"], (R, P))
        self.greedy = self._greedy(R)
        a1 = torch.empty(R, dtype=torch.int32, device=dev)
        G = mix["prefill_rows"]
        for a in range(0, R, G):
            toks = torch.as_tensor(self.prompts[a:a + G], device=dev)
            logits, _ = self.prefill(self.params, toks,
                                     _rows(self.cache, a, a + G))
            a1[a:a + G] = self._choose(logits[:, -1, :], self.greedy[a:a + G])
            del logits
        self.a1 = a1
        self._phase("cache prefill")
        # each row's answers: lengths in a seeded cycle, row r starting at
        # its place r in it; an answer of n tokens is its first token and
        # n - 1 decode steps, after which the row restarts
        order = gen.rng(self.seed, 12).permutation(len(lens))
        restart = np.zeros((MAX_STEPS, R), dtype=bool)
        self.answers = []                  # (row, first step, end step, n)
        for r in range(R):
            t, j = 0, r
            while t < MAX_STEPS:
                n = lens[order[j % len(lens)]]
                end = t + n - 1
                if end <= MAX_STEPS:
                    restart[end - 1, r] = True
                    self.answers.append((r, t, end, n))
                t, j = end, j + 1
        self.restart = torch.as_tensor(restart, device=dev)
        self.hist = torch.empty((R, MAX_STEPS), dtype=torch.int32, device=dev)
        self.P = P
        self._reset()
        for _ in range(2):                      # warm the step's shapes
            self._step()
        self._phase("schedule and warm-up steps")
        self._reset()
        self.unit = self._step

    def _reset(self) -> None:
        R = self.mix["rows"]
        self.s = 0
        self.pos = torch.full((R,), self.P, dtype=torch.int32,
                              device=self.device)
        self.tok = self.a1[:, None].clone()
        self.marks = None

    def _step(self) -> None:
        s = self.s
        if s >= MAX_STEPS:
            raise RuntimeError(f"more than {MAX_STEPS} decode steps")
        with self.spans("decode_step"):
            logits, _ = self.decode(self.params, self.tok, self.pos,
                                    self.cache)
            new = self._choose(logits[:, -1, :], self.greedy)
        self.hist[:, s] = new
        rs = self.restart[s]
        self.pos = torch.where(rs, self.P, self.pos + 1)
        self.tok = torch.where(rs, self.a1, new)[:, None]
        if self.marks is not None:
            self.marks.append(self._mark())
        self.s = s + 1

    # -- prefill -----------------------------------------------------------
    def _setup_prefill(self) -> None:
        mix, dev = self.mix, self.device
        B, lengths = mix["prompts_per_round"], mix["lengths"]
        self.cache = self.stacked.init_cache(self.arch, B, max(lengths), dev)
        self.greedy = self._greedy(B)
        r = gen.rng(self.seed, 13)
        span = mix["check_from_rounds"]
        longest = [i for i in range(span)
                   if lengths[i % len(lengths)] == max(lengths)]
        rest = [i for i in range(span) if i not in longest]
        self.check_rounds = {int(r.choice(longest))} | {
            int(i) for i in r.choice(rest, mix["check_rounds"] - 1,
                                     replace=False)}
        self.kept = {}
        self.rounds = []
        self.i = -len(lengths)                 # warm-up rounds: one a length
        for _ in lengths:
            self._round()
        self._phase("warm-up rounds")
        self.rounds = []
        self.unit = self._round

    def _round(self) -> None:
        i = self.i
        lengths = self.mix["lengths"]
        L = lengths[i % len(lengths)]
        toks = gen.prompts(gen.rng(self.seed, 1000 + max(i, 0)),
                           self.cfg["vocab_size"],
                           (self.mix["prompts_per_round"], L))
        t0 = self._mark()
        with self.spans("prefill_round"):
            logits, _ = self.prefill(
                self.params, torch.from_numpy(toks).to(self.device),
                self.cache)
            served = self._choose(logits[:, -1, :], self.greedy).cpu()
        t1 = self._mark()
        self.rounds.append((t0, t1, L))
        if i in self.check_rounds:
            # what a greedy request of each prefix would be served
            first = self._choose(logits.reshape(-1, logits.shape[-1]), None)
            self.kept[i] = (toks, first.view(toks.shape).cpu().numpy(),
                            served.numpy())
        self.i = i + 1

    # -- the harness's loop --------------------------------------------------
    def begin_window(self) -> None:
        if self.mix["kind"] == "decode":
            self.s0 = self.s
            self.marks = [self._mark()]
        else:
            self.rounds = []

    def metrics(self, window_s: float) -> dict:
        if self.mix["kind"] == "decode":
            steps = self.s - self.s0
            self.attempted = steps * self.mix["rows"]
            itl = [self._ms(a, b) for a, b in zip(self.marks, self.marks[1:])]
            return {"decode_tok_per_s": steps * self.mix["rows"] / window_s,
                    "itl_p95_ms": p95(itl)}
        self.attempted = len(self.rounds) * self.mix["prompts_per_round"]
        return {"ttft_p95_ms": p95([self._ms(a, b)
                                    for a, b, _ in self.rounds])}

    def trace_counters(self, units: int) -> dict:
        if self.mix["kind"] == "decode":
            tokens = units * self.mix["rows"]
        else:
            tokens = self.mix["prompts_per_round"] * sum(
                L for _, _, L in self.rounds[-units:])
        return {"steps": units,
                "model_flops": accounting.model_flops(self.cfg, tokens)}

    # -- correctness ---------------------------------------------------------
    def check(self, control: bool = False) -> dict:
        if self.mix["kind"] == "decode":
            return self._check_decode(control)
        return self._check_prefill(control)

    def _check_decode(self, control: bool) -> dict:
        """The finished answers drawn from the seed, ``check_answers`` in
        all, half greedy and half sampled: of each kind the longest
        finished, then one from each half of the rows, then any."""
        kinds = {True: 1, False: self.mix["top_k"]}
        want = self.mix["check_answers"]
        greedy = self.greedy.cpu().numpy()
        R = self.mix["rows"]
        r = gen.rng(self.seed, 14)
        picked = []
        for kind in kinds:
            done = [a for a in self.answers
                    if greedy[a[0]] == kind and a[2] <= self.s]
            n = want // 2
            if not done:
                continue
            longest = [a for a in done if a[3] == max(x[3] for x in done)]
            got = [longest[int(r.integers(len(longest)))]]
            for half in (range(R // 2), range(R // 2, R)):
                left = [a for a in done if a[0] in half and a not in got]
                if left and len(got) < n and not any(a[0] in half
                                                     for a in got):
                    got.append(left[int(r.integers(len(left)))])
            rest = [a for a in done if a not in got]
            for j in r.choice(len(rest), min(n - len(got), len(rest)),
                              replace=False):
                got.append(rest[int(j)])
            picked += [(a, kinds[kind]) for a in got]
        hist = self.hist[:, :self.s].cpu().numpy()
        a1 = self.a1.cpu().numpy()
        P = self.P
        cases = []
        for (row, t, end, n), k in picked:
            answer = np.concatenate([[a1[row]], hist[row, t:end]])
            seq = np.concatenate([self.prompts[row], answer[:-1]])
            cases.append((seq, P, np.arange(P - 1, P + n - 1), answer, k))
        return self._checks(cases, want, control)

    def _check_prefill(self, control: bool) -> dict:
        cases = []
        greedy = self.greedy.cpu().numpy()
        for i in sorted(self.kept):
            toks, first, served = self.kept[i]
            L = toks.shape[1]
            for b in range(toks.shape[0]):
                chosen = first[b].copy()
                if greedy[b]:               # the token served, as served
                    chosen[-1] = served[b]
                cases.append((toks[b], L, np.arange(L), chosen, 1))
        want = len(self.check_rounds) * self.mix["prompts_per_round"]
        return self._checks(cases, want, control)
