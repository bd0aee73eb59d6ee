"""``csrc/moe_gemm.cu``: the bound of the traced steps' grouped-GEMM calls
(each dropless MoE call's two launches, gate-up and down) over the device
time of the kernel, in %.

A call computes ``entries`` rows spread over ``groups`` held experts; the
engine reads both counts back from the device with the step's tokens and
marks them in the span log (``moe.entries``, ``moe.groups``, in call
order), which only a traced run arms (``harness/spanlog.py``).  Its bound
is max(6 d f entries / 989 TFLOP/s, bytes / 3.35 TB/s), the bytes being
the three d x f bf16 matrices of each expert that got rows, and the rows
in and out: the gathered rows read (d), the SwiGLU's output written and
read (f twice) and the down projection's output written (d), in bf16.
None without the log, the marks or the kernel's launches."""
from valetbench.harness import spanlog
from valetbench.harness.work import ELEMENT, bound_s

KERNELS = ("moe_gemm_kernel",)
DEVICE = True
__getattr__ = spanlog.steps_attr


def gemm_call(entries: int, groups: int, d: int, f: int, dtype: str = "bfloat16"):
    """(bytes, ops) of one dropless MoE call's two grouped products."""
    el = ELEMENT[dtype]
    n_bytes = groups * 3 * d * f * el + entries * (2 * d + 2 * f) * el
    return n_bytes, 6 * d * f * entries


def read(run):
    if run.trace is None:
        return None
    recs = spanlog.records()
    if recs is None or not spanlog.of_run(run, recs):
        return None
    steps = {s.index for s in run.traced_steps()}
    entries = [r.n for r in recs if r.name == "moe.entries" and r.step in steps]
    groups = [r.n for r in recs if r.name == "moe.groups" and r.step in steps]
    c = run.cell.config
    d, f = c["hidden_size"], c["intermediate_size"]
    bound = sum(bound_s(*gemm_call(e, g, d, f), "bfloat16")[0]
                for e, g in zip(entries, groups))
    t = run.trace.kernel_s(KERNELS)
    return 100.0 * bound / t if t and bound else None
