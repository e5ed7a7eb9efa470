"""Decode cells of a latent-attention MoE model (DeepSeek-V2) served by the
port's steps (``repro_torch.launch.steps.make_prefill_step`` /
``make_decode_step``) over weights the benchmark makes on the device from
the seed, in the port's stacked layout and the configuration's dtype: the
MLA leaves, the leading dense layers, and in each MoE layer the router
over all ``deployment.routed_experts_per_layer`` experts and the
``n_routed_experts`` held here (from ``deployment.first_expert_held``).

The traffic is ``lm.py``'s decode kind with shared prompts: ``rows`` rows
over ``prompts`` distinct prompts of ``prompt_len`` tokens, consecutive
rows asking the same one.  Set-up prefills each prompt once, one row a
call, and copies that row's cache into the rows that share it.  Then the
rows decode continuously, each through its cycle of answer lengths,
rewinding to its prompt's end after each answer, as in ``lm.py``, with
its metrics.  Every row is greedy: it is served the argmax, and no
sampler runs.  The configuration turns on the port's ``decode_graphs``, so
on the card the step replays its kernels from CUDA graphs
(``steps.make_decode_step``), recorded in set-up: eager, its ~2900
launches take the host longer to issue than the card to run (on H100
machines, 78 to 127 ms of host against 73 ms of card a step).

The traced run's profiled slice replays the graphs, as the window does
(the device's idle share, the MFU, kernels by name).  The program's spans
fire only where its Python runs, so ``trace_counters`` then profiles as
many steps run eagerly and charges each kernel to the spans around the
host op that launched it (``span_kernels``): a span's device time is its
kernels' own, the kernels the graphs replay.

The check runs the plain float32 reference
(``reference/deepseek_v2.py``) over ``check_answers`` finished answers:
the longest, one from each half of the rows, the rest drawn from the
seed, each token judged by how far the reference's logit of it lies
below the reference's best (``logit_gap_mean``).

``trace_counters`` gives the traced steps' work from the schedule (the
tokens, the cache positions they attend to, the model's FLOPs and the
bytes the attention must read: ``accounting_mla``) and the eager slice's
spans and counters.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import accounting_mla, gen, span_kernels
from portbench.drivers import lm

WARM_STEPS = 320         # decode steps in set-up on the card (~23 s)


def arch_config(cfg: dict):
    """The port's ArchConfig of a configuration file (a TypeError on a port
    without DeepSeek-V2's routing, held experts and YaRN: it cannot serve
    the configuration)."""
    from repro_torch.models.config import ArchConfig, MLA
    port, rs, dep = cfg["port"], cfg["rope_scaling"], cfg["deployment"]
    dt = cfg["torch_dtype"]
    L = cfg["num_hidden_layers"]
    return ArchConfig(
        name=cfg["name"], family="moe", n_layers=L,
        d_model=cfg["hidden_size"], vocab=cfg["vocab_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["v_head_dim"], rope_theta=float(cfg["rope_theta"]),
        d_ff=cfg["intermediate_size"], moe=True,
        n_routed_experts=accounting_mla.experts_per_layer(cfg),
        n_shared_experts=cfg["n_shared_experts"],
        moe_top_k=cfg["num_experts_per_tok"],
        d_ff_expert=cfg["moe_intermediate_size"],
        moe_layer_start=cfg["first_k_dense_replace"],
        moe_capacity_factor=port["moe_capacity_factor"],
        n_group=cfg["n_group"], topk_group=cfg["topk_group"],
        norm_topk_prob=cfg["norm_topk_prob"],
        routed_scaling_factor=float(cfg["routed_scaling_factor"]),
        n_experts_held=cfg["n_routed_experts"],
        first_expert_held=dep["first_expert_held"],
        rope_scaling_factor=float(rs["factor"]),
        rope_original_max_position=rs["original_max_position_embeddings"],
        rope_beta_fast=float(rs["beta_fast"]),
        rope_beta_slow=float(rs["beta_slow"]),
        rope_mscale=float(rs["mscale"]),
        rope_mscale_all_dim=float(rs["mscale_all_dim"]),
        q_lora_rank=cfg["q_lora_rank"], kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], layer_pattern=(MLA,) * L,
        router_impl=port["router_impl"], attn_impl=port["attn_impl"],
        decode_graphs=port["decode_graphs"], param_dtype=dt,
        compute_dtype=dt)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The benchmark's weights, one draw a stacked leaf from one generator
    on the device, in the served dtype (the router in float32): normal
    with scale 1/sqrt(fan-in), the token embedding 0.02, norms 1.  The
    leaves are named as ``reference/deepseek_v2.py`` reads them."""
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    H, ql, kvl = (cfg["num_attention_heads"], cfg["q_lora_rank"],
                  cfg["kv_lora_rank"])
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    nd = cfg["first_k_dense_replace"]
    m = L - nd
    E, held = accounting_mla.experts_per_layer(cfg), cfg["n_routed_experts"]
    ff, dff = cfg["moe_intermediate_size"], cfg["intermediate_size"]
    sff = cfg["n_shared_experts"] * ff
    dt = getattr(torch, cfg["torch_dtype"])
    g = torch.Generator(device=device)
    g.manual_seed(seed & (2 ** 63 - 1))

    def normal(shape, fan_in, dtype=dt, std=None):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, std or fan_in ** -0.5, generator=g)

    ones = lambda *s: torch.ones(s, dtype=dt, device=device)
    return {"tok": normal((V, d), None, std=0.02),
            "head": normal((d, V), d), "final_norm": ones(d),
            "norm1": ones(L, d), "norm2": ones(L, d),
            "wq_a": normal((L, d, ql), d), "q_norm": ones(L, ql),
            "wq_b": normal((L, ql, H * (dn + dr)), ql),
            "wkv_a": normal((L, d, kvl + dr), d), "kv_norm": ones(L, kvl),
            "wk_b": normal((L, kvl, H * dn), kvl),
            "wv_b": normal((L, kvl, H * dv), kvl),
            "wo": normal((L, H * dv, d), H * dv),
            "mlp_wi": normal((nd, d, 2 * dff), d),
            "mlp_wo": normal((nd, dff, d), dff),
            "router": normal((m, d, E), d, dtype=torch.float32),
            "wi": normal((m, held, d, 2 * ff), d),
            "we": normal((m, held, ff, d), ff),
            "swi": normal((m, d, 2 * sff), d),
            "swo": normal((m, sff, d), sff)}


def _part(t: torch.Tensor, a: int, n: int) -> torch.Tensor:
    """Layers a .. a + n of a stacked leaf as a run of the port stacks
    them: one layer unstacked, several stacked (views)."""
    return t[a] if n == 1 else t[a:a + n]


def port_params(w: dict, arch) -> dict:
    """The same tensors in the port's stacked parameter tree (views);
    refused unless every leaf's path, shape and dtype is the port's own."""
    from repro_torch import tree
    from repro_torch.models import stacked
    segs, a = [], 0
    for run in stacked.segments(arch):
        n = run.count
        p = lambda name: _part(w[name], a, n)
        seg = {"norm1": {"w": p("norm1")}, "norm2": {"w": p("norm2")},
               "attn": {k: p(k) for k in ("wq_a", "q_norm", "wq_b", "wkv_a",
                                          "kv_norm", "wk_b", "wv_b", "wo")}}
        if run.sig.moe:
            b = a - arch.moe_layer_start
            q = lambda name: _part(w[name], b, n)
            seg["moe"] = {"router": q("router"), "wi": q("wi"),
                          "wo": q("we"),
                          "shared": {"wi": q("swi"), "wo": q("swo")}}
        else:
            seg["mlp"] = {"wi": p("mlp_wi"), "wo": p("mlp_wo")}
        segs.append(seg)
        a += n
    params = {"embed": {"tok": w["tok"], "head": w["head"]},
              "final_norm": {"w": w["final_norm"]}, "segments": segs}
    want = {p: (tuple(t.shape), t.dtype) for p, t in tree.flatten_with_path(
        stacked.init_params(arch, None, "meta"))}
    got = {p: (tuple(t.shape), t.dtype)
           for p, t in tree.flatten_with_path(params)}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"the benchmark's weights are not the port's "
                         f"layout: {diff}")
    return params


class Cell(lm.Cell):
    """A decode cell over shared prompts, every row greedy."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans):
        super().__init__(cfg, mix, seed, device, spans)
        if mix["kind"] != "decode":
            raise ValueError(f"{__name__} serves decode traffic, not "
                             f"{mix['kind']!r}")
        if mix["greedy_share"] != 1.0:
            raise ValueError("every row of a latent-attention cell is greedy")

    def setup(self) -> None:
        self.phases, self._t = {}, time.perf_counter()
        from repro_torch.launch import steps
        from repro_torch.models import stacked
        self.stacked = stacked
        self.arch = arch_config(self.cfg)
        self._phase("imports")
        self.weights = make_weights(self.cfg, self.seed, self.device)
        self.params = port_params(self.weights, self.arch)
        self._phase("weights")
        self.prefill = steps.make_prefill_step(self.arch)
        self.decode = steps.make_decode_step(self.arch)
        self.eager = getattr(self.decode, "eager", self.decode)
        self._setup_decode()

    def _choose(self, lg: torch.Tensor, greedy) -> torch.Tensor:
        return lg.argmax(dim=-1).to(torch.int32)

    def _rows(self, a: int, b: int) -> list:
        """Rows a:b of every segment's cache (views: writes land in it)."""
        return [{k: v.narrow(len(self.stacked._lead(run)), a, b - a)
                 for k, v in c.items()}
                for run, c in zip(self.stacked.segments(self.arch),
                                  self.cache)]

    def _setup_decode(self) -> None:
        mix, dev = self.mix, self.device
        R, P, n = mix["rows"], mix["prompt_len"], mix["prompts"]
        lens = mix["answer_lens"]
        self.cache = self.stacked.init_cache(self.arch, R, P + max(lens), dev)
        distinct = gen.prompts(gen.rng(self.seed, 10), self.cfg["vocab_size"],
                               (n, P))
        per = R // n                         # rows asking each prompt
        self.prompts = distinct[np.arange(R) // per]
        self.greedy = self._greedy(R)
        a1 = torch.empty(R, dtype=torch.int32, device=dev)
        for j in range(n):
            src = j * per
            logits, _ = self.prefill(
                self.params, torch.as_tensor(distinct[j:j + 1], device=dev),
                self._rows(src, src + 1))
            a1[src:src + per] = self._choose(logits[:, -1, :], None)
            del logits
            for have, rows in zip(self._rows(src, src + 1),
                                  self._rows(src + 1, src + per)):
                for k, v in rows.items():
                    v.copy_(have[k].expand_as(v))
        self.a1 = a1
        self._phase("cache prefill")
        # each row's answers: lengths in a seeded cycle, row r starting at
        # its place r in it; an answer of n tokens is its first token and
        # n - 1 decode steps, after which the row restarts
        order = gen.rng(self.seed, 12).permutation(len(lens))
        restart = np.zeros((lm.MAX_STEPS, R), dtype=bool)
        self.answers = []                  # (row, first step, end step, n)
        for r in range(R):
            t, j = 0, r
            while t < lm.MAX_STEPS:
                m = lens[order[j % len(lens)]]
                end = t + m - 1
                if end <= lm.MAX_STEPS:
                    restart[end - 1, r] = True
                    self.answers.append((r, t, end, m))
                t, j = end, j + 1
        self.restart = torch.as_tensor(restart, device=dev)
        self.hist = torch.empty((R, lm.MAX_STEPS), dtype=torch.int32,
                                device=dev)
        self.P = P
        self._reset()
        # warm the step's shapes (the first call records its graphs on the
        # card), then, on the card, run it until its pace settles: after the
        # prompts' prefill an H100 ran 44 % of the steps of the next 17 s
        # ~0.9 ms slower (73.3 against 72.4 ms), and 0.4-1.7 % of those of
        # the 51 s after, so the window's p95 read one or the other from run
        # to run
        for _ in range(WARM_STEPS if self.cuda else 2):
            self._step()
        self._phase("schedule and warm-up steps")
        self._reset()
        self.unit = self._step

    def free(self) -> None:
        self.eager = None
        super().free()

    def attended(self, s0: int, s1: int) -> int:
        """Cache positions that steps s0..s1 - 1 attend to, over the rows:
        at step s a row in an answer begun at step t is at position
        P + s - t and attends to that many positions and itself."""
        total = 0
        for _, t, end, _ in self.answers:
            a, b = max(s0, t), min(s1, end)
            if a < b:
                # sum over s in [a, b) of P + 1 + s - t
                total += ((b - a) * (self.P + 1 - t)
                          + (a + b - 1) * (b - a) // 2)
        return total

    def trace_counters(self, units: int) -> dict:
        """The traced steps' work, then that of ``units`` more steps run
        eagerly under a profile of their own: their device time charged to
        the program's spans, the program's counters, and the positions the
        attention read and the bytes it had to read."""
        tokens = units * self.mix["rows"]
        att = self.attended(self.s - units, self.s)
        out = {"steps": units,
               "model_flops": accounting_mla.model_flops(self.cfg, tokens,
                                                         att)}
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.runtime import spans
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        graphed, self.decode = self.decode, self.eager
        spans.reset()
        s0 = self.s
        try:
            with profile(activities=acts) as prof:
                for _ in range(units):
                    self._step()
                self.sync()
        finally:
            self.decode = graphed
        att = self.attended(s0, self.s)
        out.update({
            "eager_steps": units,
            "eager_span_ms": span_kernels.charge(prof.events()),
            "eager_counters": dict(spans.report()["counters"]),
            "mla_attend_bytes": accounting_mla.attend_bytes(self.cfg, att),
            "mla_attended_slots": att * self.cfg["num_hidden_layers"]})
        return out

    def _check_decode(self, control: bool) -> dict:
        """``check_answers`` finished answers drawn from the seed: the
        longest finished, then one from each half of the rows, then any."""
        want = self.mix["check_answers"]
        R = self.mix["rows"]
        r = gen.rng(self.seed, 14)
        done = [a for a in self.answers if a[2] <= self.s]
        got = []
        if done:
            longest = [a for a in done if a[3] == max(x[3] for x in done)]
            got.append(longest[int(r.integers(len(longest)))])
            for half in (range(R // 2), range(R // 2, R)):
                left = [a for a in done if a[0] in half and a not in got]
                if left and not any(a[0] in half for a in got):
                    got.append(left[int(r.integers(len(left)))])
            rest = [a for a in done if a not in got]
            for j in r.choice(len(rest), min(want - len(got), len(rest)),
                              replace=False):
                got.append(rest[int(j)])
        hist = self.hist[:, :self.s].cpu().numpy()
        a1 = self.a1.cpu().numpy()
        P = self.P
        cases = []
        for row, t, end, n in got[:want]:
            answer = np.concatenate([[a1[row]], hist[row, t:end]])
            seq = np.concatenate([self.prompts[row], answer[:-1]])
            cases.append((seq, P, np.arange(P - 1, P + n - 1), answer, 1))
        return self._checks(cases, want, control)
