"""Device time of the MoE router's kernels a decode step: the key pack
(``bitplane_pack.cu``) and the top-k (``radix_topk.cu``, any of its
three forms), by name, summed over the traced steps, over the steps.
Milliseconds."""

ROUTER = ("pack_kernel", "topk_warp_kernel", "topk_select_kernel",
          "topk_rounds_kernel")


def read(t):
    steps = t.counters.get("steps")
    ks = t.kernels(*ROUTER)
    if not steps or not ks:
        return None
    return sum(b - a for a, b, _ in ks) / 1e3 / steps
