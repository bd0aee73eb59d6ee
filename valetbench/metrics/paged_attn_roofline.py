"""``csrc/paged_attention.cu``: the bound of the traced steps' decode
attention (every full-attention layer's call over the step's decoded rows,
each row's true KV length at the pool's dtype, q and out; ``work.py``) over
the device time of the kernels below, in %.  None without their
launches."""
KERNELS = ("paged_split_kernel", "paged_combine_kernel")
DEVICE = True


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_s(KERNELS)
    bound = sum(run.model.paged_bound(s.decodes, run.page) for s in run.traced_steps())
    return 100.0 * bound / t if t and bound else None
