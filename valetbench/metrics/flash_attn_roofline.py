"""``csrc/flash_attention_tc.cu`` (and the f32 ``flash_attention.cu``):
the bound of the traced steps' prefill attention (every attention layer's
causal or banded triangle, q, k, v and out once; ``work.py``) over the
device time of the kernels below, in %.  None without their launches."""
KERNELS = ("flash_tc_kernel", "flash_fwd_kernel")
DEVICE = True


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_s(KERNELS)
    bound = sum(run.model.flash_bound(s.prefills) for s in run.traced_steps())
    return 100.0 * bound / t if t and bound else None
