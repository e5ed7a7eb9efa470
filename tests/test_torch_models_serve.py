"""The port's sampling (``repro_torch.models.sampling``) and the one-shot
model-decode loop (``python -m repro_torch.launch.serve --oneshot``) on
the CPU.  The reference's ``jax.random.categorical`` has no torch
counterpart that draws the same tokens, so the tests hold what can be held
exactly: the top-k mask, greedy tokens, every sampled token inside its
mask, and the prompt (the same numpy draw in both packages)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import sort as ref_sort
from repro.models import sampling as RSm
from repro.models import transformer as RT
from repro_torch import configs, sort, tree
from repro_torch.launch import serve
from repro_torch.models import sampling as Sm
from repro_torch.models import transformer as T

CPU = "cpu"
SUMMARY = re.compile(r"^\[serve\] prefill \d+ms, decode [\d.]+ tok/s, "
                     r"prune=\d+%")


def _logits(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 3


@pytest.mark.parametrize("k", [1, 8, 50, 256])
def test_topk_mask_matches_reference(k):
    lg = _logits((4, 256), 0)
    lg[1, :100] = 0.5                     # a tie set straddling the k-th
    want = ref_sort.topk_mask(jnp.asarray(lg), k, largest=True)
    got = sort.topk_mask(torch.tensor(lg), k, largest=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("temperature", [0.0, -1.0])
def test_greedy_matches_reference(temperature):
    lg = _logits((8, 300), 1)
    want = RSm.sample_logits(jnp.asarray(lg), jax.random.PRNGKey(0), 5,
                             temperature)
    got = Sm.sample_logits(torch.tensor(lg), torch.Generator(), 5,
                           temperature)
    assert got.dtype is torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_k,temperature", [(8, 1.0), (1, 1.0),
                                               (32, 0.7)])
def test_sampled_tokens_lie_inside_the_mask(top_k, temperature):
    lg = torch.tensor(_logits((16, 512), 2))
    mask = sort.topk_mask(lg / temperature, top_k, largest=True)
    gen = torch.Generator().manual_seed(3)
    seen = set()
    for _ in range(50):
        tok = Sm.sample_logits(lg, gen, top_k, temperature)
        assert bool(mask[torch.arange(16), tok.long()].all())
        seen.update(tok.tolist())
    if top_k > 1:
        assert len(seen) > 16            # it samples, not argmax


def test_sampling_follows_the_softmax():
    # Gumbel-max over 20000 draws of one row: frequencies within 0.015 of
    # the softmax probabilities (3 sigma is under 0.01)
    lg = torch.tensor([[0.0, 1.0, 2.0, -1.0]]).expand(20000, 4)
    tok = Sm.sample_logits(lg, torch.Generator().manual_seed(4))
    freq = np.bincount(tok.numpy(), minlength=4) / 20000
    np.testing.assert_allclose(freq, torch.softmax(lg[0], -1).numpy(),
                               atol=0.015)


def test_generate_greedy_matches_reference():
    rcfg = ref_configs.get_config("olmo_1b").reduced()
    cfg = configs.get_config("olmo_1b").reduced()
    params = RT.init_params(rcfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(5).integers(0, rcfg.vocab, (2, 4))
    want = RSm.generate(params, rcfg, jnp.asarray(prompt, jnp.int32),
                        max_new=6, key=jax.random.PRNGKey(0), top_k=16,
                        temperature=0.0)
    got = Sm.generate(tree.params_from_numpy(params, CPU), cfg,
                      torch.tensor(prompt), max_new=6, gen=None, top_k=16,
                      temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_topk_sampling():
    cfg = configs.get_config("olmo_1b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    prompt = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                            (2, 4)))
    out = Sm.generate(params, cfg, prompt, max_new=6,
                      gen=torch.Generator().manual_seed(0), top_k=16)
    assert tuple(out.shape) == (2, 10)
    assert bool(((out >= 0) & (out < cfg.vocab)).all())
    assert torch.equal(out[:, :4], prompt.to(torch.int32))


# ---------------------------------------------------------------------------
# The one-shot model decode.
# ---------------------------------------------------------------------------


def _oneshot(arch, *extra):
    return ["--oneshot", "--arch", arch, "--device", CPU, "--layers", "2",
            "--d-model", "64", "--vocab", "128", "--batch", "2",
            "--prompt-len", "4", "--max-new", "5", *extra]


@pytest.mark.parametrize("arch,router", [
    ("olmo_1b", None), ("qwen2_moe_a2_7b", "radix"),
    ("qwen2_moe_a2_7b", "pallas"), ("qwen2_moe_a2_7b", "lax"),
    ("qwen2_moe_a2_7b", "fused-topk"), ("qwen2_moe_a2_7b", "torch")])
def test_oneshot_cli_runs(arch, router, capsys):
    extra = ["--top-k", "8", "--prune", "0.3"]
    if router:
        extra += ["--router-impl", router]
    res = serve.main(_oneshot(arch, *extra))
    out = capsys.readouterr().out.splitlines()
    assert re.match(r"^\[serve\] in-situ pruned: weight sparsity "
                    r"\d+\.\d%$", out[0])
    assert SUMMARY.match(out[1]) and out[1].endswith("prune=30%")
    assert out[2].startswith("[serve] first sequence: [")
    tokens = res["tokens"]
    assert tokens.shape == (2, 9)
    # the reference's prompt: the same numpy draw from the seed
    np.testing.assert_array_equal(
        tokens[:, :4], np.random.default_rng(0).integers(0, 128, (2, 4)))
    assert ((tokens >= 0) & (tokens < 128)).all()


@pytest.mark.parametrize("arch", ["qwen3_14b", "gemma_7b", "deepseek_7b",
                                  "deepseek_v2_236b", "mamba2_1_3b",
                                  "zamba2_2_7b", "llama_3_2_vision_90b",
                                  "musicgen_medium"])
def test_oneshot_cli_runs_every_arch(arch, capsys):
    # the other eight archs (olmo-1b and qwen2-moe above), at 4 layers: a
    # periodic segment for zamba2, llama and musicgen, a stacked MoE run
    # for deepseek-v2; mamba2 has no MLP to prune
    res = serve.main(_oneshot(arch, "--top-k", "8", "--prune", "0.3",
                              "--layers", "4"))
    out = capsys.readouterr().out.splitlines()
    sparsity = float(re.match(r"^\[serve\] in-situ pruned: weight sparsity "
                              r"(\d+\.\d)%$", out[0]).group(1))
    assert (sparsity == 0.0) == (arch == "mamba2_1_3b")
    assert SUMMARY.match(out[1])
    assert res["tokens"].shape == (2, 9)
    assert ((res["tokens"] >= 0) & (res["tokens"] < 128)).all()


def test_oneshot_gives_the_frontend_to_every_step(monkeypatch):
    """A fusion arch's prefill and each decode step get the frontend stub,
    as the reference's ``serve`` passes it."""
    from repro_torch.data import pipeline
    from repro_torch.models import stacked
    seen = []
    real = stacked.forward

    def spy(params, cfg, tokens, frontend=None, **kw):
        seen.append(frontend)
        return real(params, cfg, tokens, frontend=frontend, **kw)

    monkeypatch.setattr(stacked, "forward", spy)
    cfg = configs.get_config("musicgen_medium").reduced(n_layers=4)
    serve.serve(cfg, 2, 4, 5, top_k=8, device=CPU)
    want = pipeline.frontend_stub(cfg, 2, CPU)
    assert len(seen) == 5
    assert all(fe is not None and torch.equal(fe, want) for fe in seen)


def test_oneshot_every_router_serves_the_same_tokens():
    runs = [serve.main(_oneshot("qwen2_moe_a2_7b", "--top-k", "8",
                                "--router-impl", r))["tokens"]
            for r in ("radix", "pallas", "lax")]
    for t in runs[1:]:
        np.testing.assert_array_equal(t, runs[0])


def test_oneshot_fault_spec(capsys):
    res = serve.main(_oneshot("qwen2_moe_a2_7b", "--top-k", "8",
                              "--fault-spec", "ber=0.01,seed=0"))
    out = capsys.readouterr().out
    assert "[serve] fault pre-flight: quality=" in out
    assert "[serve] fault counters: reads=" in out
    summary = [ln for ln in out.splitlines() if SUMMARY.match(ln)]
    assert len(summary) == 1 and "degraded=False" in summary[0]
    assert res["probe"]["degraded"] is False


def test_oneshot_serve_function_prompt_and_greedy(capsys):
    cfg = configs.get_config("gemma_7b").reduced()
    res = serve.serve(cfg, 3, 5, 4, top_k=0, seed=7, device=CPU)
    np.testing.assert_array_equal(
        res["tokens"][:, :5],
        np.random.default_rng(7).integers(0, cfg.vocab, (3, 5)))
    assert res["tokens"].shape == (3, 9) and res["pruned"] == 0.0
    assert res["prefill_s"] > 0 and res["decode_tok_per_s"] > 0


def test_oneshot_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _oneshot("olmo_1b") if a not in ("--device", CPU)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(args)


def test_oneshot_needs_an_arch():
    with pytest.raises(SystemExit):
        serve.main(["--oneshot", "--device", CPU])
