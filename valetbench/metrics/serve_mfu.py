"""Model FLOPs of the window's useful tokens over (window seconds x 989
TFLOP/s, the H100's dense bf16 peak), in %.  Useful tokens are the prompt
tokens of first-time prefills and the decoded tokens; each is counted
from shapes (``work.Model``): the products with the weights, attention
over its true causal or windowed context, the SSM's conv and recurrence,
and a logits row for each generated token."""
from valetbench.harness.work import PEAK_FLOPS

DEVICE = True


def read(run):
    m = run.model
    flops = sum(sum(m.prefill_flops(s) for s in st.prefills)
                + sum(m.decode_flops(n) for n in st.decodes)
                for st in run.window_steps())
    return 100.0 * flops / (run.window_s * PEAK_FLOPS["bfloat16"])
