"""``csrc/ssd_scan.cu``: the bound of the traced steps' SSD scans (every
SSM layer's scan of each prefill; ``work.py``) over the device time of the
scan's five passes, in %.  None without their launches."""
KERNELS = ("ssd_lc_kernel", "ssd_cb_kernel", "ssd_state_kernel",
           "ssd_pass_kernel", "ssd_out_kernel")
DEVICE = True


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_s(KERNELS)
    bound = sum(run.model.ssd_bound(s.prefills) for s in run.traced_steps())
    return 100.0 * bound / t if t and bound else None
