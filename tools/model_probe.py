#!/usr/bin/env python3
"""Device memory and decode-step profile of the port's model serving path
on one CUDA card (qwen2-moe-a2.7b at full width and depth by default).

    python3 tools/model_probe.py [--arch qwen2_moe_a2_7b]

Prints the allocated and peak device memory after ``stacked.init_params``
and after the ``--oneshot`` CLI, and the profiler's kernel time a decode
step by kernel name (batch 4, prompt 16, router ``fused-topk``).  Needs a
card; builds the key-pack and top-k kernels at first use.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

GIB = 2 ** 30


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.launch import serve, steps
    from repro_torch.models import stacked

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_moe_a2_7b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("model_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get_config(args.arch),
                              router_impl="pallas")

    def mem(what):
        print(f"{what}: allocated {torch.cuda.memory_allocated() / GIB:.2f} "
              f"GiB, peak {torch.cuda.max_memory_allocated() / GIB:.2f} GiB",
              flush=True)

    torch.cuda.reset_peak_memory_stats()
    params = stacked.init_params(
        cfg, torch.Generator(device=dev).manual_seed(1), dev)
    torch.cuda.synchronize()
    mem("after init_params")

    batch, plen, steps_n = 4, 16, 3
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, plen)), dtype=torch.int32, device=dev)
    caches = stacked.init_cache(cfg, batch, plen + 2 * steps_n + 1, dev)
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    logits, _ = prefill(params, prompt, caches)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    pos = torch.full((batch,), plen, dtype=torch.int32, device=dev)
    for i in range(steps_n):                       # warm-up
        decode(params, tok, pos + i, caches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps_n):
            decode(params, tok, pos + steps_n + i, caches)
        torch.cuda.synchronize()
    print(f"{steps_n} decode steps, batch {batch}:", flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=15), flush=True)
    del params, caches, logits
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serve.main(["--oneshot", "--arch", args.arch, "--full-size",
                "--router-impl", "pallas", "--batch", "4", "--prompt-len",
                "16", "--max-new", "32", "--top-k", "32", "--prune", "0.3"])
    mem("after the --oneshot CLI")
    return 0


if __name__ == "__main__":
    sys.exit(main())
