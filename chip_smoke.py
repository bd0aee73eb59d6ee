"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/csrc`` and
counts the tensor-core instructions in each kernel's SASS (phase 1), holds
each kernel against its plain PyTorch version on the card and checks that
two calls give the same bits and that a row of the paged kernel keeps its
bits when the other rows of its batch change, and times the host tier's
page kernel at granite's shapes and its whole page move against one pinned
copy of the same bytes (phase 2), checks
the port's CUDA path against its CPU path on reduced configs (phase 3), then
drives the main paths through ``ValetServeEngine`` with and without
KV-pool pressure: full-width granite-3-8b (8 of 40 layers, every policy;
phase 4), full-width gemma3-4b at 6 layers with prompts past its 1024-token
window (phase 5), full-width hymba-1.5b (8 of 32 layers, the three global
ones among them: paged, ring and SSD state together; phase 6) and
full-width mamba2-2.7b (16 of 64 layers, SSD state only; phase 7), then
serves granite-3-8b to three tenants that lease
their KV pools from one ``HostMemoryCoordinator`` and donate idle slots to
each other, checking each tenant's tokens against its solo run and the
coordinator's books (phase 8), serves full-width deepseek-moe-16b (6 of 28
layers: 1 dense + 5 MoE) under pressure with every policy, after holding a
MoE layer's decode rows bit-identical whatever the rest of the batch holds
(phase 9), and runs full-width llama-3.2-vision-11b (10 of 40 layers, 6656
patch tokens) and whisper-large-v3 (8 + 8 of 32 + 32 layers, 1536 frames) through
prefill and decode, held against their full forward in f32, then in bf16
(phase 10).  Phase 11 trains: ten steps of the port's ``make_train_step``
(bf16 compute, two microbatches, remat, AdamW) on full-width granite-3-8b
(8 of 40 layers) and mamba2-2.7b (16 of 64 layers, the SSD scan's forward
on the kernel under autograd), then holds the scan's gradients against the
plain scan's, a reduced train step of every arch against the CPU, and a
``ValetCheckpointer`` round trip with a resumed step.  Phase 12 runs the
sharded serve step (``launch/serve_step.py``): the paged kernel's partial
entry at granite's and gemma3's global-layer decode shapes over pages split
round-robin across 1, 2, 4 and 8 ranks, each rank's partials held against
the plain version and all combined against one unsplit call (f32, bf16;
int8 pools against the plain partials combined), then full-width
granite-3-8b (4 of 40 layers) and gemma3-4b (6 of 34) in f32 on one rank
(a 1x1 mesh over NCCL) held against ``models.decode``, and on four ranks
(2x2) sharing the card over gloo, fed the one rank's tokens and held
against its logits, with one migration step checked against the moved
pages.  Phase 13 runs the sharded prefill cell (``launch/specs.py``: the
sharded ``prefill_logits``, each rank's attention on the flash kernel and
its SSD heads on the SSD kernel) and the serve step of the other kinds:
full-width hymba-1.5b (4 of 32 layers), deepseek-moe-16b (2 of 28, EP over
64 experts) and whisper-large-v3 (2 + 2 of 32 + 32, cross K/V over 1536
frames), f32, on one rank (NCCL) held against the unsharded
``prefill_logits`` and ``models.decode`` (whisper's without the position
``models.decode`` adds to a decode token, which the reference's serve step
does not), and on four gloo ranks sharing the card held against one rank;
then every shape the phase gave a kernel is held against the kernel's plain
version on fresh inputs.  Phase 14 trains sharded (``make_train_step`` on a
rank mesh: ZeRO-1, the vocab-sharded loss, remat with the collectives
saved): full-width mamba2-2.7b (4 of 64 layers, each rank's SSD heads on
the kernel under autograd) in f32 on one rank (NCCL) held against one
device, on four gloo ranks sharing the card (2x2) held against one rank,
then in bf16 for timing, and one step on 2x1 and on 1x2 held against one
rank; the 2-stage GPipe step of full-width granite-3-8b (2 of 40 layers)
over two pod ranks held against one device's step; then every shape the
phase gave the SSD kernel against its plain version.  Phase 15 sets the
meta-device dry run (``launch/dryrun.py``) beside the card: phase 14's
one-rank train cell (``build_train_cell``, 1x1, bf16) timed for one step
with CUDA events and its peak memory read, against the H100 roofline bound
and the argument bytes of the same cell run on meta; then the port's
``examples/policy_comparison_torch.py`` (every policy exact) and
``examples/fault_tolerance_torch.py`` (the restore exact, no page lost)
on the card, and every shape the phase gave a kernel against its plain
version.  Phase 16 serves full-width granite-4.0-h-small (6 of 40 layers:
5 Mamba-2 and 1 NoPE attention, each with a dropless MoE over 18 of 72
experts) with and without pressure, tokens held equal, after holding a
dropless MoE call's counted entries to those routed to the held experts
and a decode row's bits to the rest of its batch; phase 2 times the
dropless MoE's grouped GEMM at that model's decode and prefill shapes.
Each main path runs with every kernel's launch count
set to 0 just before it and read just after, and fails unless each of its
kernels launched and no plain version ran on a CUDA tensor.  Any failed
phase exits non-zero.

Its last lines are the card's name and power limit, one JSON line with each
kernel's launches on the main path, error, times and bound, and finally
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SSD_BF16_ABS_ERR = 1e-3
# calls of each kernel's plain version on CUDA tensors (main() counts them)
PLAIN_CUDA_CALLS = {"paged": 0, "paged_partials": 0, "flash": 0, "ssd": 0,
                    "host_pages": 0, "moe_gemm": 0, "kv_append": 0}


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"FAILED: {msg}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps=30, flush=None):
    """Median of ``reps`` CUDA-event timings of ``fn()`` (after a warm-up);
    ``flush()`` runs before each timed call, outside the timed window."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def l2_flush(dev="cuda"):
    """A callable that evicts the L2 (50 MB) by rewriting 256 MB: an int32
    ``bitwise_not_``, a kernel no measured call launches, so ``device_ms``
    can leave it out by name."""
    return torch.empty(64 << 20, dtype=torch.int32, device=dev).bitwise_not_


# the kernels of a flush (or of the marker), by the size of its tensor:
# learnt from the first window of it alone that holds each exactly once per
# call.  Late in a long run the profiler often records nothing in a window
# that small, while windows with the measured call in them come back whole
BETWEEN_KERNELS = {}


def device_ms(fn, reps=20, flush=None, tries=8):
    """Device time of one call of ``fn``: the summed time of the CUDA kernels
    it launches, from ``torch.profiler`` over ``reps`` calls after a warm-up.
    Unlike ``time_ms`` it leaves out the host time of the call (a wrapper's
    checks, allocations and launches), which events around a single call
    include when the device waits for the host.  Before each call runs
    ``flush()`` (``l2_flush``), or else a one-element marker of the same
    kind; their kernels (``BETWEEN_KERNELS``) are left out of the sum.

    The profiler may drop some of a window's kernel events.  So each kernel
    counts at its mean time, times its whole number of launches per call; a
    window is taken again when a kernel's count is a quarter or more off a
    whole number per call, or the flush's kernels are missing."""
    from torch.profiler import ProfilerActivity, profile
    between = flush or torch.zeros(1, dtype=torch.int32, device="cuda").bitwise_not_
    size = between.__self__.numel()

    def kernels(f):
        """Per kernel name: (launches per call, mean us)."""
        f()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                f()
            torch.cuda.synchronize()
        return {e.key: (e.count / reps, e.self_device_time_total / e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.count}

    for attempt in range(1, tries + 1):
        if size not in BETWEEN_KERNELS:
            alone = kernels(between)
            if alone and all(n == round(n) >= 1 for n, _ in alone.values()):
                BETWEEN_KERNELS[size] = {k: round(n) for k, (n, _) in alone.items()}
            else:
                log(f"    device_ms: window {attempt} of the flush alone lost kernel "
                    f"events ({[round(n, 2) for n, _ in alone.values()]}); taken again")
                continue
        skip = BETWEEN_KERNELS[size]
        both = kernels(lambda: (between(), fn()))
        seen = {k: round(both.get(k, (0, 0))[0]) for k in skip}
        lost = [f"{n:.2f}" for n, _ in both.values()
                if round(n) < 1 or abs(n - round(n)) >= 0.25 * round(n)]
        if not lost and any(seen[k] > n for k, n in skip.items()):
            fail(f"device_ms: the measured call launches the flush's kernels {list(skip)}")
        if not lost and len(both) > len(skip) and seen == skip:
            return sum(round(n) * us for k, (n, us) in both.items() if k not in skip) / 1e3
        log(f"    device_ms: window {attempt} lost kernel events (launches per call "
            f"{lost or [round(n, 2) for n, _ in both.values()]}); taken again")
    fail(f"device_ms: the profiler lost kernel events in {tries} windows")


def timings(kernel_fn, plain_fn, library_fn, *, flush=None, plain_reps=30):
    """The kernels JSON's times of one case: ``ms``, ``plain_ms`` and
    ``library_ms`` are CUDA-event timings of one call (``time_ms``);
    ``device_ms``, ``plain_device_ms`` and ``library_device_ms`` are the
    device time of the kernels the same calls launch (``device_ms``)."""
    return dict(ms=time_ms(kernel_fn, flush=flush),
               plain_ms=time_ms(plain_fn, reps=plain_reps, flush=flush),
               library_ms=None if library_fn is None else time_ms(library_fn),
               device_ms=device_ms(kernel_fn, flush=flush),
               plain_device_ms=device_ms(plain_fn, reps=min(plain_reps, 20), flush=flush),
               library_device_ms=None if library_fn is None else device_ms(library_fn))


def times_text(t):
    lib = ("library none" if t["library_ms"] is None else
           f"library {t['library_ms']:.4f} ms (device {t['library_device_ms']:.4f})")
    return (f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f})  plain "
            f"{t['plain_ms']:.4f} ms (device {t['plain_device_ms']:.4f})  {lib}")


def bound_ms(n_bytes, n_ops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def assert_repeatable(name, first, again):
    """Two calls of a kernel on the same inputs must give the same bits: the
    exactness checks of the main paths compare runs that each compute their
    own prefills."""
    for a, b in zip(first, again):
        if not torch.equal(a, b):
            fail(f"{name}: two calls on the same inputs differ "
                 f"(max abs diff {max_err(a, b):.3e})")


def sass_mma_counts(path):
    """Tensor-core instructions (HMMA / HGMMA) per kernel symbol in the SASS
    of the built library, from ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = shutil.which("cuobjdump") or str(Path(CUDA_HOME or "/usr/local/cuda")
                                            / "bin" / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


def phase_sass(path):
    """Print the tensor-core instruction count of every kernel, and fail
    unless the bf16 routes (flash tensor-core kernels, the bf16 SSD passes
    with products) hold HMMA/HGMMA instructions."""
    counts = sass_mma_counts(path)
    for name, n in sorted(counts.items()):
        log(f"  sass: {n:5d} HMMA/HGMMA  {name}")
    must = [k for k in counts if "flash_tc_kernel" in k
            or (("ssd_cb_kernel" in k or "ssd_state_kernel" in k or "ssd_out_kernel" in k)
                and "bfloat16" in k)]
    if not must:
        fail("sass: no tensor-core flash or bf16 SSD kernel found in the library")
    empty = [k for k in must if counts[k] == 0]
    if empty:
        fail(f"sass: no tensor-core instruction in {empty}")


def assert_close(name, out, ref, dtype):
    tol = TOL[dtype]
    if not torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol):
        fail(f"{name}: kernel disagrees with plain version "
             f"(max abs err {max_err(out, ref):.3e}, tol {tol})")
    if not torch.isfinite(out.float()).all():
        fail(f"{name}: non-finite output")


# --------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def paged_inputs(b, hq, hkv, d, page, max_len, q_dtype, kv_dtype, seed, min_len=1,
                 n_pages=None):
    """Rows of min_len..max_len tokens (row 0 the longest) over tables of
    ``n_pages`` pages (the lengths' pages and 2 more by default) in a
    shuffled pool; row 1 has a -1 hole at its second page."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_len, max_len + 1, size=b).astype(np.int32)
    lengths[0] = max_len
    p = n_pages or -(-max_len // page) + 2            # room for -1 pads
    n_slots = b * p + 8
    bt = np.full((b, p), -1, np.int32)
    perm = rng.permutation(n_slots)
    used = 0
    for i in range(b):
        n = -(-int(lengths[i]) // page)
        bt[i, :n] = perm[used:used + n]
        used += n
    if b > 1 and -(-int(lengths[1]) // page) > 2:
        bt[1, 1] = -1                                 # a hole mid-sequence
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hq, d), device=dev, generator=g).to(q_dtype)
    kp = torch.randn((n_slots, page, hkv, d), device=dev, generator=g).to(kv_dtype)
    vp = torch.randn((n_slots, page, hkv, d), device=dev, generator=g).to(kv_dtype)
    return q, kp, vp, torch.from_numpy(bt).to(dev), torch.from_numpy(lengths).to(dev)


def paged_case(name, b, hq, hkv, d, page, max_len, q_dtype, kv_dtype, seed, timed=True,
               **rows):
    from repro_torch.kernels import paged_attention as pa
    q, kp, vp, btt, lt = paged_inputs(b, hq, hkv, d, page, max_len, q_dtype, kv_dtype,
                                      seed, **rows)
    bt, lengths, p = btt.cpu().numpy(), lt.cpu().numpy(), btt.shape[1]
    dev = "cuda"
    out = pa.paged_attention(q, kp, vp, btt, lt)
    ref = pa.paged_attention_plain(q, kp, vp, btt, lt)
    torch.cuda.synchronize()
    tol_dtype = torch.bfloat16 if torch.bfloat16 in (q_dtype, kv_dtype) else torch.float32
    assert_close(name, out, ref, tol_dtype)
    assert_repeatable(name, [out], [pa.paged_attention(q, kp, vp, btt, lt)])
    if not timed:
        log(f"  {name}: err {max_err(out, ref):.3e}")
        return None
    # live tokens only: pages behind a -1 slot are never read
    live = sum(max(0, min(page, int(lengths[i]) - pi * page))
               for i in range(b) for pi in range(p) if bt[i, pi] >= 0)
    kv_el = torch.finfo(kv_dtype).bits // 8
    q_el = torch.finfo(q_dtype).bits // 8
    n_bytes = 2 * live * hkv * d * kv_el + 2 * b * hq * d * q_el + bt.nbytes + lengths.nbytes
    n_ops = 4 * live * (hq // hkv) * hkv * d
    kernel_fn = lambda: pa.paged_attention(q, kp, vp, btt, lt)  # noqa: E731
    plain_fn = lambda: pa.paged_attention_plain(q, kp, vp, btt, lt)  # noqa: E731
    times = timings(kernel_fn, plain_fn, None, flush=l2_flush(dev))
    bms, by = bound_ms(n_bytes, n_ops, kv_dtype)
    n_splits = pa.plan_for(q, kp, btt)[1]
    rec = dict(max_abs_err=max_err(out, ref), bound_ms=bms, bound_by=by,
               n_splits=n_splits, **times)
    log(f"  {name}: {n_splits} splits  err {rec['max_abs_err']:.3e}  "
        f"{times_text(times)}  bound {bms:.4f} ms ({by}; "
        f"{100 * bms / times['device_ms']:.1f}% of the device time)")
    return rec


def paged_batch_independence(q_dtype, kv_dtype, trials=3):
    """Row 0's output must keep its bits when the other rows' tables and
    lengths change (granite's decode shape): the exactness checks of the main
    paths compare runs whose batches differ."""
    from repro_torch.kernels import paged_attention as pa
    q, kp, vp, btt, lt = paged_inputs(8, 32, 8, 128, 16, 600, q_dtype, kv_dtype, seed=11)
    first = pa.paged_attention(q, kp, vp, btt, lt)
    g = torch.Generator(device="cuda").manual_seed(11)
    for trial in range(trials):
        bt2, lt2 = btt.clone(), lt.clone()
        bt2[1:] = torch.randint(-1, kp.shape[0], bt2[1:].shape, device="cuda", generator=g,
                                dtype=torch.int32)
        lt2[1:] = torch.randint(0, 641, lt2[1:].shape, device="cuda", generator=g,
                                dtype=torch.int32)
        again = pa.paged_attention(q, kp, vp, bt2, lt2)
        if not torch.equal(first[0], again[0]):
            fail(f"paged batch independence: row 0 changed (max abs diff "
                 f"{max_err(first[0], again[0]):.3e}) when the other rows changed "
                 f"(trial {trial})")
    log(f"  paged batch independence (q {str(q_dtype)[6:]}, pool {str(kv_dtype)[6:]}): "
        f"row 0 bit-identical over {trials} changes of the other rows' tables and "
        f"lengths")


def band_mask(s, causal, window, dev, sk=None):
    """(s, sk) boolean mask of the (query, key) pairs attention reads (sk
    defaults to s)."""
    i = torch.arange(s, device=dev)
    j = torch.arange(s if sk is None else sk, device=dev)
    mask = torch.ones((s, j.shape[0]), dtype=torch.bool, device=dev)
    if causal:
        mask &= j[None, :] <= i[:, None]
    if window > 0:
        mask &= j[None, :] > i[:, None] - window
    return mask


def flash_case(name, hq, hkv, d, s, causal, window, dtype, seed, sk=None, timed=True):
    """The flash kernel against its plain version and SDPA, q (hq, s, d) and
    k/v (hkv, sk, d) (sk defaults to s): one prefill of one sequence, every
    head; a cross-attention or an encoder when not causal.  ``timed=False``
    holds the kernel against its plain version only."""
    from repro_torch.kernels import flash_attention as fa
    dev = "cuda"
    sk = s if sk is None else sk
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((hq, s, d), device=dev, generator=g).to(dtype)
    k = torch.randn((hkv, sk, d), device=dev, generator=g).to(dtype)
    v = torch.randn((hkv, sk, d), device=dev, generator=g).to(dtype)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert_close(name, out, ref, dtype)
    assert_repeatable(name, [out], [fa.flash_attention(q, k, v, causal=causal,
                                                       window=window)])
    if not timed:
        log(f"  {name}: err {max_err(out, ref):.3e}")
        return None
    mask = band_mask(s, causal, window, dev, sk)
    pairs = int(mask.sum())
    el = torch.finfo(dtype).bits // 8
    n_bytes = (2 * hq * s + 2 * hkv * sk) * d * el
    n_ops = 4 * pairs * hq * d
    # library yardstick: one SDPA call on the same inputs (KV heads expanded
    # to the query heads beforehand; a window's mask as a boolean band)
    grp = hq // hkv
    q4 = q[None]
    k4 = k.repeat_interleave(grp, dim=0)[None]
    v4 = v.repeat_interleave(grp, dim=0)[None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window > 0:
        lib_fn = lambda: sdpa(q4, k4, v4, attn_mask=mask)  # noqa: E731
    else:
        lib_fn = lambda: sdpa(q4, k4, v4, is_causal=causal)  # noqa: E731
    times = timings(lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
                    lambda: fa.flash_attention_plain(q, k, v, causal=causal,
                                                     window=window), lib_fn)
    bms, by = bound_ms(n_bytes, n_ops, dtype)
    rec = dict(max_abs_err=max_err(out, ref), bound_ms=bms, bound_by=by, **times)
    log(f"  {name}: err {rec['max_abs_err']:.3e}  {times_text(times)}  bound "
        f"{bms:.4f} ms ({by})")
    if dtype == torch.bfloat16:
        # the tensor-core route rounds P to bf16 for P.V: its error against
        # f32 attention on the same (bf16) inputs beside that of the plain
        # version in bf16 and of SDPA
        ref32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                         causal=causal, window=window)
        lib_out = lib_fn()[0]
        log(f"    against f32 attention: kernel {max_err(out, ref32):.3e}, plain "
            f"bf16 {max_err(ref, ref32):.3e}, sdpa {max_err(lib_out, ref32):.3e} "
            f"(|out| <= {float(ref32.abs().max()):.3g})")
    return rec


def ssd_case(name, b, s, h, p, g, n, chunk, dtype, seed, s_real=None, timed=True):
    """The SSD kernel against its plain version on model-like inputs: the
    init's decay A = -linspace(1, 16) and dt = softplus(N(0, 0.5^2) +
    dt_bias); steps past ``s_real`` are the zero padding of a prefill.
    ``timed=False`` holds the kernel against its plain version only."""
    from repro_torch.kernels import ssd_scan as ssd
    dev = "cuda"
    g_ = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, s, h, p), device=dev, generator=g_).to(dtype)
    bm = torch.randn((b, s, g, n), device=dev, generator=g_).to(dtype)
    cm = torch.randn((b, s, g, n), device=dev, generator=g_).to(dtype)
    dt_bias = torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, h, device=dev)))
    dt = torch.nn.functional.softplus(
        0.5 * torch.randn((b, s, h), device=dev, generator=g_) + dt_bias)
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    if s_real is not None:
        for t in (x, bm, cm, dt):
            t[:, s_real:] = 0
    y, hT = ssd.ssd_scan(x, dt, a, bm, cm, chunk)
    y_ref, h_ref = ssd.ssd_scan_plain(x, dt, a, bm, cm, chunk)
    torch.cuda.synchronize()
    tol = 3e-4 if dtype == torch.float32 else 2e-2
    for what, out, ref in (("y", y, y_ref), ("h_final", hT, h_ref)):
        if not torch.allclose(out, ref, atol=tol, rtol=tol):
            fail(f"{name} {what}: kernel disagrees with plain version "
                 f"(max abs err {max_err(out, ref):.3e}, tol {tol})")
        if not torch.isfinite(out).all():
            fail(f"{name} {what}: non-finite output")
        # the bf16 route splits each f32 operand into bf16 hi + lo; one bf16
        # rounding of it alone (~2^-9 relative, |y| up to ~30) would pass the
        # 2e-2 above but not this absolute limit (PR 13 measured <= 1.2e-4)
        if dtype == torch.bfloat16 and max_err(out, ref) > SSD_BF16_ABS_ERR:
            fail(f"{name} {what}: max abs err {max_err(out, ref):.3e} over the "
                 f"bf16 split's limit {SSD_BF16_ABS_ERR}")
    assert_repeatable(name, [y, hT], ssd.ssd_scan(x, dt, a, bm, cm, chunk))
    if not timed:
        log(f"  {name}: err {max(max_err(y, y_ref), max_err(hT, h_ref)):.3e}")
        return None
    el = torch.finfo(dtype).bits // 8
    n_bytes = (b * s * h * p * el + b * s * h * 4 + h * 4 + 2 * b * s * g * n * el
               + b * s * h * p * 4 + b * h * p * n * 4)
    # multiply-adds x 2 per chunk: C.B^T once per group over the s <= t
    # pairs, the masked matrix times x, C.h_prev and the state update
    pairs = chunk * (chunk + 1) // 2
    n_ops = 2 * b * (s // chunk) * (g * pairs * n + h * pairs * p
                                    + 2 * h * chunk * p * n)
    times = timings(lambda: ssd.ssd_scan(x, dt, a, bm, cm, chunk),
                    lambda: ssd.ssd_scan_plain(x, dt, a, bm, cm, chunk), None,
                    plain_reps=10)
    bms, by = bound_ms(n_bytes, n_ops, dtype)
    err = max(max_err(y, y_ref), max_err(hT, h_ref))
    rec = dict(max_abs_err=err, bound_ms=bms, bound_by=by, **times)
    log(f"  {name}: err {err:.3e} (|y| <= {float(y_ref.abs().max()):.3g})  "
        f"{times_text(times)}  bound {bms:.4f} ms ({by})")
    return rec


def host_pages_case(name, n, seed, layers=40, page=16, kv=8, hd=128):
    """The host tier's page kernel at granite-3-8b's f32 pool (40 paged
    layers, 5,242,880 B a page) over ``n`` pages: gather and scatter held
    bit-exact against the plain version, the gather's device time against
    its HBM bound (a read and a write of each page); then the whole move of
    the pages to pinned host memory and back (``move_pages``: the kernel
    and the copies through the engine's 64-page staging buffer) against
    one pinned ``copy_`` of the same bytes each way, the PCIe yardstick."""
    from repro_torch.core.device_ops import HostPageArena
    from repro_torch.kernels import host_pages as hp
    dev = "cuda"
    n_slots = n + 64
    g = torch.Generator(device=dev).manual_seed(seed)
    pools = [torch.randn((n_slots, page, kv, hd), device=dev, generator=g)
             for _ in range(2 * layers)]
    rng = np.random.default_rng(seed)
    slots = rng.permutation(n_slots)[:n].tolist()
    table = hp.pool_table(pools)
    shape = (n, 2 * layers, page, kv, hd)
    stage, ref = torch.empty(shape, device=dev), torch.empty(shape, device=dev)
    hp.host_pages(stage, pools, slots, True, table)
    hp.host_pages_plain(ref, pools, slots, True)
    torch.cuda.synchronize()
    if not torch.equal(stage, ref):
        fail(f"{name}: gather differs from the plain version")
    dst = rng.permutation(n_slots)[:n].tolist()
    a, b = [p.clone() for p in pools], [p.clone() for p in pools]
    hp.host_pages(stage, a, dst, False)
    hp.host_pages_plain(stage, b, dst, False)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"{name}: scatter differs from the plain version")
    del a, b
    times = timings(lambda: hp.host_pages(stage, pools, slots, True, table),
                    lambda: hp.host_pages_plain(ref, pools, slots, True), None,
                    flush=l2_flush(dev), plain_reps=10)
    page_bytes = stage[0].nbytes
    bms, by = bound_ms(2 * n * page_bytes, 0, torch.float32)
    # the whole move, as the arena issues it, against one large pinned copy
    host = torch.empty(shape, pin_memory=True)
    addrs = host.data_ptr() + page_bytes * np.arange(n, dtype=np.int64)
    staging = torch.empty((HostPageArena.STAGE_PAGES,) + shape[1:], device=dev)
    copies = hp.move_pages.copies
    hp.move_pages(staging, pools, table, slots, addrs, True)
    torch.cuda.synchronize()
    if not torch.equal(host, ref.cpu()):
        fail(f"{name}: the move to the host differs from the plain gather")
    n_copies = hp.move_pages.copies - copies
    d2h = time_ms(lambda: hp.move_pages(staging, pools, table, slots, addrs, True), reps=10)
    h2d = time_ms(lambda: hp.move_pages(staging, pools, table, slots, addrs, False),
                  reps=10)
    d2h_ref = time_ms(lambda: host.copy_(ref, non_blocking=True), reps=10)
    h2d_ref = time_ms(lambda: ref.copy_(host, non_blocking=True), reps=10)
    gb = n * page_bytes / 1e9
    rec = dict(max_abs_err=0.0, bound_ms=bms, bound_by=by, pages=n,
               page_bytes=page_bytes, move_d2h_ms=d2h, move_h2d_ms=h2d,
               pinned_copy_d2h_ms=d2h_ref, pinned_copy_h2d_ms=h2d_ref,
               move_copies=n_copies, **times)
    log(f"  {name}: bit-exact  {times_text(times)}  bound {bms:.4f} ms ({by}; "
        f"{100 * bms / times['device_ms']:.1f}% of the device time); the move of "
        f"{gb:.3f} GB ({n_copies} copies a move): to the host {d2h:.3f} ms "
        f"({gb / d2h * 1e3:.1f} GB/s), back {h2d:.3f} ms ({gb / h2d * 1e3:.1f} GB/s); "
        f"one pinned copy_ of the same bytes {d2h_ref:.3f} ms ({gb / d2h_ref * 1e3:.1f} "
        f"GB/s) and {h2d_ref:.3f} ms ({gb / h2d_ref * 1e3:.1f} GB/s)")
    return rec


def moe_routing(t, seed, experts=72, k=10, held=18, f=768):
    """The dropless MoE's groups for ``t`` rows routed top-``k`` over
    ``experts`` by random logits, the first ``held`` experts held here, by
    the path's own ``models.moe.groups``: (offsets, rows, counts, n_max,
    block_m)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as M
    moe = MoEConfig(n_experts=experts, top_k=k, d_expert=f, dropless=True,
                    held_first=0, held_count=held)
    g = torch.Generator(device="cuda").manual_seed(seed)
    eids = torch.randn((t, experts), device="cuda", generator=g).topk(k, dim=-1).indices
    _, order, counts, offsets, n_max, bm = M.groups(eids, moe)
    return offsets, (order // k).to(torch.int32), counts, n_max, bm


def grouped_mm_library(x, offsets, rows, entries, wg, wu, wd):
    """The same two products by ``torch._grouped_mm`` (the library's
    grouped GEMM, a yardstick only: the port never calls it) over the
    gathered rows, or None where this torch has none or it refuses."""
    gmm = getattr(torch, "_grouped_mm", None)
    if gmm is None:
        return None, "torch has no _grouped_mm"
    ends = offsets[1:].contiguous()
    col = lambda w: w.transpose(1, 2).contiguous().transpose(1, 2)

    def lib(wg=wg, wu=wu, wd=wd):
        a = x[rows[:entries].long()]
        h = torch.nn.functional.silu(gmm(a, wg, offs=ends).float()).to(a.dtype) * \
            gmm(a, wu, offs=ends)
        return gmm(h, wd, offs=ends)
    for layout in (lambda w: w, col):
        try:
            ws = [layout(w) for w in (wg, wu, wd)]
            lib(*ws)
            torch.cuda.synchronize()
            return (lambda: lib(*ws)), None
        except (RuntimeError, NotImplementedError, TypeError) as e:   # refused
            why = str(e).splitlines()[0][:120]
    return None, why


def moe_case(name, t, seed, d=4096, f=768, held=18):
    """One dropless MoE call's two grouped products (gate-up with the
    SwiGLU, then down) at granite-4.0-h-small's widths over ``t`` rows
    routed top-10 over 72 experts, 18 held: the kernel against its plain
    version, twice bit for bit, and timed beside its bound (the held
    experts' weights that got rows and the rows in and out, or 6 d f FLOPs
    an entry) and ``torch._grouped_mm``."""
    from repro_torch.kernels import moe_gemm as mg
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16
    x = torch.randn((t, d), device="cuda", generator=g).to(bf16)
    wg, wu = ((torch.randn((held, d, f), device="cuda", generator=g) / d ** 0.5).to(bf16)
              for _ in range(2))
    wd = (torch.randn((held, f, d), device="cuda", generator=g) / f ** 0.5).to(bf16)
    offsets, rows, counts, n_max, bm = moe_routing(t, seed, held=held, f=f)
    entries, groups = int(counts.sum()), int((counts > 0).sum())

    def run():
        h = mg.moe_gemm(x, offsets, wg, wu, rows=rows, n_rows=n_max, block_m=bm)
        return mg.moe_gemm(h, offsets, wd, n_rows=n_max + 1, block_m=bm)

    def plain():
        h = mg.moe_gemm_plain(x, offsets, wg, wu, rows=rows, n_rows=n_max)
        return mg.moe_gemm_plain(h, offsets, wd, n_rows=n_max + 1)
    y, y_ref = run(), plain()
    torch.cuda.synchronize()
    assert_close(name, y[:entries], y_ref[:entries], bf16)
    assert_repeatable(name, [y[:entries]], [run()[:entries]])
    lib, why = grouped_mm_library(x, offsets, rows, entries, wg, wu, wd)
    times = timings(run, plain, lib, plain_reps=5)
    n_bytes = groups * 3 * d * f * 2 + entries * (2 * d + 2 * f) * 2
    bms, by = bound_ms(n_bytes, 6 * d * f * entries, bf16)
    err = max_err(y[:entries], y_ref[:entries])
    log(f"  {name}: {entries} entries in {groups} groups (block_m {bm}): err {err:.3e}  "
        f"{times_text(times)}  bound {bms:.4f} ms ({by})"
        + (f"; library: {why}" if lib is None else ""))
    return dict(max_abs_err=err, bound_ms=bms, bound_by=by, entries=entries,
                groups=groups, **times)


def kv_append_case(name, b=64, n_slots=2400, page=16, kv=8, hd=128, seed=24):
    """The decode step's paged append at granite-3-8b's batch and f32 pool
    (bf16 rows, a quarter of the rows inactive and aimed at slot 0, past
    the pool or below it): the kernel against its plain version and
    against the eager append it replaces (``live_rows``' ``nonzero()`` and
    two ``index_put_``, the library column), bit for bit, and timed beside
    its bound (a read of each live row and a write into the pool)."""
    from repro_torch.core import device_ops as dev_ops
    from repro_torch.kernels import kv_append as kva
    g = torch.Generator(device="cuda").manual_seed(seed)
    pool = [torch.randn((n_slots, page, kv, hd), device="cuda", generator=g)
            for _ in range(2)]
    k, v = (torch.randn((b, kv, hd), device="cuda", generator=g).to(torch.bfloat16)
            for _ in range(2))
    row = torch.arange(b, device="cuda")
    mask = row % 4 != 1
    slot = torch.where(mask, torch.randperm(n_slots, device="cuda", generator=g)[:b],
                       torch.tensor([0, n_slots, -1, 7], device="cuda")[row // 4 % 4])
    off = row % page
    outs = []
    for fn in (lambda p: kva.kv_append(p[0], p[1], k, v, slot, off, mask),
               lambda p: kva.kv_append_plain(p[0], p[1], k, v, slot, off, mask),
               lambda p: dev_ops.append_token_masked(
                   dev_ops.KVPool(*p), k, v, slot, off, mask,
                   rows=dev_ops.live_rows(mask, slot, n_slots))):
        p = [t.clone() for t in pool]
        fn(p)
        outs.append(p)
    torch.cuda.synchronize()
    for other in outs[1:]:
        if not all(torch.equal(a, c) for a, c in zip(outs[0], other)):
            fail(f"{name}: the kernel's pool differs from the plain or eager append")
    times = timings(lambda: kva.kv_append(pool[0], pool[1], k, v, slot, off, mask),
                    lambda: kva.kv_append_plain(pool[0], pool[1], k, v, slot, off, mask),
                    lambda: dev_ops.append_token_masked(
                        dev_ops.KVPool(*pool), k, v, slot, off, mask,
                        rows=dev_ops.live_rows(mask, slot, n_slots)),
                    plain_reps=5)
    live = int(mask.sum())
    bms, by = bound_ms(2 * live * kv * hd * (2 + 4), 0, torch.float32)
    log(f"  {name}: {live} of {b} rows append: {times_text(times)}  bound {bms:.4f} ms "
        f"({by}); library: the eager append with live_rows")
    return dict(max_abs_err=0.0, bound_ms=bms, bound_by=by, **times)


def phase_kernels():
    log("phase 2: kernels against their plain versions on the card (ms: CUDA "
        "events around one call, the wrapper's host cost included whenever "
        "the card waits for it; device: the summed time of the kernels the "
        "call launches, torch.profiler)")
    recs = {}
    recs[("kv_append",)] = kv_append_case(
        "kv_append granite decode B64 Hkv8 D128 bf16 rows into an f32 pool of 2400 pages")
    # the dropless MoE's grouped GEMM at granite-4.0-h-small's decode (128
    # rows) and prefill (2048 tokens) shapes
    recs[("moe", "decode")] = moe_case(
        "moe_gemm granite-4.0-h-small decode T128 top-10 of 72, 18 held, d4096 f768", 128,
        seed=22)
    recs[("moe", "prefill")] = moe_case(
        "moe_gemm granite-4.0-h-small prefill T2048 top-10 of 72, 18 held, d4096 f768",
        2048, seed=23)
    for n in (45, 140):
        recs[("host_pages", n)] = host_pages_case(
            f"host_pages granite 40 layers f32 pool, {n} pages", n, seed=20 + n)
        gc.collect()
        torch.cuda.empty_cache()
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt)[6:]
        recs[("ssd", "mamba2", dt)] = ssd_case(
            f"ssd mamba2 B1 S1024 H80 P64 G1 N128 chunk256 {tag}",
            1, 1024, 80, 64, 1, 128, 256, dt, seed=6)
        ssd_case(f"ssd hymba B1 S1300->1536 H50 P64 G1 N16 chunk256 {tag}",
                 1, 1536, 50, 64, 1, 16, 256, dt, seed=7, s_real=1300)
        ssd_case(f"ssd mamba2 B1 S77 chunk77 (ragged) {tag}",
                 1, 77, 80, 64, 1, 128, 77, dt, seed=8)
    for qd, kd in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                   (torch.bfloat16, torch.bfloat16)):
        tag = f"q {str(qd)[6:]} pool {str(kd)[6:]}"
        r = paged_case(f"paged granite B8 Hq32 Hkv8 D128 page16 len<=600 {tag}",
                       8, 32, 8, 128, 16, 600, qd, kd, seed=1)
        recs[("paged", qd, kd)] = r
        paged_case(f"paged gemma3 B8 Hq8 Hkv4 D256 page16 len<=600 {tag}",
                   8, 8, 4, 256, 16, 600, qd, kd, seed=2)
        paged_batch_independence(qd, kd)
    # the global layers' decode on the gemma3 and hymba main paths (P =
    # max_seq / page = 84) and one long row, bf16 q over an f32 pool as served
    bf16, f32 = torch.bfloat16, torch.float32
    recs[("paged", "gemma3-global")] = paged_case(
        "paged gemma3-global B4 Hq8 Hkv4 D256 page16 len 1100-1316 P84 q bfloat16 pool "
        "float32", 4, 8, 4, 256, 16, 1316, bf16, f32, seed=12, min_len=1100, n_pages=84)
    recs[("paged", "hymba-global")] = paged_case(
        "paged hymba-global B8 Hq25 Hkv5 D64 page16 len 1100-1332 P84 q bfloat16 pool "
        "float32", 8, 25, 5, 64, 16, 1332, bf16, f32, seed=13, min_len=1100, n_pages=84)
    recs[("paged", "long")] = paged_case(
        "paged long B1 Hq32 Hkv8 D128 page16 len 16384 P1024 q bfloat16 pool float32",
        1, 32, 8, 128, 16, 16384, bf16, f32, seed=14, n_pages=1024)
    # the decode of phases 9 and 10's paged layers: deepseek's and whisper's
    # G = 1 (heads padded to 4 in the kernel), llama-vision's self layers
    for qd in (f32, bf16):
        tag = f"q {str(qd)[6:]} pool float32"
        recs[("paged", "whisper", qd)] = paged_case(
            f"paged whisper-dec B8 Hq20 Hkv20 D64 page16 len<=448 P28 {tag}",
            8, 20, 20, 64, 16, 448, qd, f32, seed=15, n_pages=28)
    recs[("paged", "deepseek")] = paged_case(
        "paged deepseek B8 Hq16 Hkv16 D128 page16 len<=544 P36 q bfloat16 pool float32",
        8, 16, 16, 128, 16, 544, bf16, f32, seed=16, n_pages=36)
    # bf16 q/k/v (every prefill of the main paths) runs on the tensor cores;
    # f32 on the CUDA-core kernel
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt)[6:]
        lens = (77, 512) if dt == torch.float32 else (77, 128, 256, 512)
        for s in lens:
            r = flash_case(f"flash granite Hq32 Hkv8 D128 S{s} causal {tag}",
                           32, 8, 128, s, True, 0, dt, seed=3)
            recs[("flash", s, dt)] = r
        flash_case(f"flash gemma3 Hq8 Hkv4 D256 S1100 causal window1024 {tag}",
                   8, 4, 256, 1100, True, 1024, dt, seed=4)
        flash_case(f"flash gemma3 Hq8 Hkv4 D256 S300 causal window64 {tag}",
                   8, 4, 256, 300, True, 64, dt, seed=5)
        if dt == torch.bfloat16:
            flash_case(f"flash hymba Hq25 Hkv5 D64 S1300 causal window1024 {tag}",
                       25, 5, 64, 1300, True, 1024, dt, seed=9)
        # phase 10's non-causal launches: llama-vision's cross-attention over
        # 6656 patch tokens, whisper's encoder over 1536 frames
        recs[("flash", "cross", dt)] = flash_case(
            f"flash llama-vision cross Hq32 Hkv8 D128 Sq256 Sk6656 non-causal {tag}",
            32, 8, 128, 256, False, 0, dt, seed=10, sk=6656)
        recs[("flash", "encoder", dt)] = flash_case(
            f"flash whisper encoder Hq20 Hkv20 D64 S1536 non-causal {tag}",
            20, 20, 64, 1536, False, 0, dt, seed=11)
        # whisper's decoder prefill: cross-attention of the prompt (up to
        # 256 tokens) over the 1536 encoder frames, and causal self-attention
        recs[("flash", "dec-cross", dt)] = flash_case(
            f"flash whisper dec cross Hq20 Hkv20 D64 Sq256 Sk1536 non-causal {tag}",
            20, 20, 64, 256, False, 0, dt, seed=17, sk=1536)
        recs[("flash", "dec-self", dt)] = flash_case(
            f"flash whisper dec self Hq20 Hkv20 D64 S256 causal {tag}",
            20, 20, 64, 256, True, 0, dt, seed=18)
        # deepseek's causal prefill (G = 1), its longest prompt
        recs[("flash", "deepseek", dt)] = flash_case(
            f"flash deepseek Hq16 Hkv16 D128 S512 causal {tag}",
            16, 16, 128, 512, True, 0, dt, seed=19)
    return recs


# --------------------------------------------------------------------------
# Phase 3: reduced configs, CUDA against CPU
# --------------------------------------------------------------------------

def to_device(tree, device):
    from repro_torch.bridge import tree_map
    return tree_map(lambda t: t.to(device), tree)


def run_engine(params, cfg, ctx, prompts, *, policy, pool_slots, max_batch, max_seq,
               page, max_new, device, zero_restore=True):
    from repro_torch.core.policies import POLICIES
    from repro_torch.serve import ValetServeEngine
    eng = ValetServeEngine(params, cfg, ctx, max_batch=max_batch, max_seq=max_seq,
                           page=page, pool_slots=pool_slots, policy=POLICIES[policy],
                           zero_restore=zero_restore, device=device)
    for p in prompts:
        eng.submit(p, max_new=max_new)
    t0 = time.perf_counter()
    reqs = eng.run(max_steps=10_000)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(r.status == "done" for r in reqs):
        fail(f"{cfg.name} {policy}: requests left unfinished")
    outs = [r.tokens_out for r in sorted(reqs, key=lambda r: r.rid)]
    return outs, eng.stats, wall


def open_gates(params, value=1.0):
    """Set every cross-attention gate ``xgate`` (0 at init, which shuts
    llama-vision's cross path) to ``value``, in place; True if any."""
    segs = [seg for seg in params["segments"] if "xgate" in seg]
    for seg in segs:
        seg["xgate"].fill_(value)
    return bool(segs)


REDUCED = ("granite-3-8b", "gemma3-4b", "mamba2-2.7b", "hymba-1.5b", "deepseek-moe-16b",
           "qwen2-moe-a2.7b", "llama-3.2-vision-11b", "whisper-large-v3")


def phase_reduced():
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    log("phase 3: reduced configs, CUDA (kernels) against CPU (plain), f32; "
        "llama-vision's xgate set to 1.0 so that its cross path counts")
    ctx = T.ParallelCtx(remat=False, q_block=8, kv_block=8, loss_chunk=8)
    for name in REDUCED:
        cfg = reduced(ARCHS[name])
        gen = torch.Generator().manual_seed(0)
        cpu = T.init_params(cfg, generator=gen, device="cpu")
        open_gates(cpu)
        gpu = to_device(cpu, "cuda")
        rng = np.random.default_rng(0)
        b, s, n_dec, page = 2, 12, 6, 4
        toks = rng.integers(0, cfg.vocab, size=(b, s + n_dec))
        fe = None
        if cfg.n_frontend_tokens:
            fe = torch.randn((b, cfg.n_frontend_tokens, cfg.d_model),
                             generator=torch.Generator().manual_seed(0))
        max_pages = (s + n_dec + page - 1) // page + 1
        bt = np.arange(b * max_pages, dtype=np.int32).reshape(b, max_pages)
        worst = 0.0
        logits = {}
        for dev, params in (("cpu", cpu), ("cuda", gpu)):
            caches = D.init_caches(cfg, b, pool_slots=b * max_pages + 2, page=page,
                                   device=dev)
            lg, caches = D.prefill(params, torch.from_numpy(toks[:, :s]), cfg, ctx,
                                   caches, torch.from_numpy(bt),
                                   frontend=None if fe is None else fe.to(dev))
            seq = [lg.cpu()]
            for t in range(s, s + n_dec - 1):
                lg, caches = D.decode_step(
                    params, caches, torch.from_numpy(toks[:, t]), cfg, ctx,
                    torch.from_numpy(bt), torch.from_numpy(bt[:, t // page]),
                    torch.full((b,), t % page, dtype=torch.int32))
                seq.append(lg.cpu())
            logits[dev] = seq
        for a, c in zip(logits["cpu"], logits["cuda"]):
            worst = max(worst, max_err(a[:, :cfg.vocab], c[:, :cfg.vocab]))
        if worst > 1e-4:
            fail(f"{name} reduced: CUDA logits differ from CPU by {worst:.3e}")
        if fe is not None:
            # the engine prefills without a frontend, as the reference's
            log(f"  {name} reduced: prefill+decode logits max |CUDA-CPU| {worst:.3e} "
                f"(with a frontend; not served by the engine)")
            continue
        rng = np.random.default_rng(0)
        prompts = [rng.integers(2, cfg.vocab, size=8) for _ in range(6)]
        for policy in ("valet", "valet-mass", "infiniswap", "os-swap"):
            runs = {}
            for dev, params in (("cpu", cpu), ("cuda", gpu)):
                runs[dev], _, _ = run_engine(params, cfg, ctx, prompts, policy=policy,
                                             pool_slots=10, max_batch=3, max_seq=64,
                                             page=4, max_new=10, device=dev)
            if runs["cpu"] != runs["cuda"]:
                fail(f"{name} reduced {policy}: CUDA engine tokens differ from CPU")
        log(f"  {name} reduced: prefill+decode logits max |CUDA-CPU| {worst:.3e}; "
            f"engine tokens equal under pressure (slots=10) for all four policies")


# --------------------------------------------------------------------------
# Phases 4-5: full width on the card
# --------------------------------------------------------------------------

def stats_line(st):
    return (f"steps {st.steps} tokens {st.tokens} pauses {st.pauses} spilled "
            f"{st.spilled_pages} restored {st.restored_pages} repointed "
            f"{st.repointed_pages} streamed {st.streamed_pages} deleted "
            f"{st.deleted_pages} recomputes {st.recomputes} flushed "
            f"{st.flushed_pages}; simulated (TPU_COSTS profile, not this card): "
            f"sim_time_us {st.sim_time_us} bg_time_us {st.bg_time_us}")


def serve_full(name, cfg, params, ctx, prompts, runs, **geom):
    """Serve ``prompts`` under each (label, policy, slots, zero, exact) run
    of ``runs``; the first run is the unpressured reference, and every
    ``exact`` run's tokens must equal its tokens.  Returns each run's wall
    seconds by label."""
    torch.cuda.reset_peak_memory_stats()
    ref, problems, walls = None, [], {}
    for label, policy, slots, zero, exact in runs:
        outs, st, wall = run_engine(params, cfg, ctx, prompts, policy=policy,
                                    pool_slots=slots, zero_restore=zero,
                                    device="cuda", **geom)
        n_tok = sum(len(o) for o in outs)
        walls[label] = wall
        log(f"  {name} {label}: {n_tok} tokens in {wall:.3f} s wall "
            f"({n_tok / wall:.2f} tok/s on this card); {stats_line(st)}")
        if ref is None:
            ref = outs
            continue
        diff = [(i, next(t for t, (x, y) in enumerate(zip(a, b)) if x != y))
                for i, (a, b) in enumerate(zip(outs, ref)) if a != b]
        if diff:
            msg = (f"{label}: tokens differ from the unpressured run in "
                   f"{len(diff)} of {len(ref)} requests (request, first "
                   f"differing token): {diff}")
            if exact:
                problems.append(msg)
            else:
                log(f"  not held to exactness: {msg}")
        else:
            log(f"  {name} {label}: tokens identical to the unpressured run")
        if label.startswith("valet zero") and not (st.pauses > 0
                                                   and st.repointed_pages > 0):
            problems.append(f"{label}: pressure did not preempt and repoint")
    log(f"  {name}: torch.cuda.max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if problems:
        fail(f"{name}: " + "; ".join(problems))
    return walls


def restore_walls(name, walls):
    """Zero-restore's and legacy restore's serving walls side by side, each
    the mean of its runs (zero, legacy, ..., legacy, zero: ``abba_tail``)."""
    zero = [w for label, w in walls.items() if label.startswith("valet zero")]
    legacy = [w for label, w in walls.items() if label.startswith("valet legacy")]
    z, lg = float(np.mean(zero)), float(np.mean(legacy))
    log(f"  {name} restore walls, same call: valet zero-restore "
        f"{' / '.join(f'{w:.3f}' for w in zero)} s (mean {z:.3f}), valet legacy "
        f"{' / '.join(f'{w:.3f}' for w in legacy)} s (mean {lg:.3f}); zero-restore / "
        f"legacy {z / lg:.3f}")


def profile_decode(name, cfg, params, ctx, prompts, *, steps=8, pool_slots=512,
                   **geom):
    """Profile ``steps`` steady decode steps of a full batch (admissions
    happen before the window): host wall per step, device busy time per
    step, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ValetServeEngine
    eng = ValetServeEngine(params, cfg, ctx, pool_slots=pool_slots, device="cuda",
                           max_batch=geom["max_batch"], max_seq=geom["max_seq"],
                           page=geom["page"])
    for p in prompts[:geom["max_batch"]]:
        eng.submit(p, max_new=steps + 4)
    eng.step()                       # admits (prefills) the whole batch
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: CPU ops also carry the device time of what they launched
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in ev)
    paged_us = sum(e.self_device_time_total for e in ev if "valet::paged_" in e.key)
    log(f"  {name} decode profile (batch {geom['max_batch']}, {steps} steps): "
        f"{1e3 * wall / steps:.3f} ms wall per step, device busy "
        f"{busy_us / 1e3 / steps:.3f} ms per step "
        f"({100 * busy_us / 1e6 / wall:.1f}% of wall), "
        f"{sum(e.count for e in ev) // steps} kernel launches per step; paged "
        f"kernel (both passes) {paged_us / 1e3 / steps:.3f} ms per step "
        f"({100 * paged_us / max(busy_us, 1):.1f}% of busy)")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{e.count // steps:5d} calls/step  {e.key[:90]}")


@contextlib.contextmanager
def off_path():
    """Kernel launches made inside (profiles, timings, drift checks that call
    the model directly, kernels held against their plain versions), and the
    plain versions' calls on CUDA tensors there, are left out of the main
    path's counts."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import host_pages as hp
    from repro_torch.kernels import kv_append as kva
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ssd
    wrappers = (fa.flash_attention, pa.paged_attention, pa.paged_attention_partials,
                ssd.ssd_scan, hp.host_pages, mg.moe_gemm, kva.kv_append)
    before = [w.launches for w in wrappers]
    plain_before = dict(PLAIN_CUDA_CALLS)
    try:
        yield
    finally:
        for w, n in zip(wrappers, before):
            w.launches = n
        PLAIN_CUDA_CALLS.update(plain_before)


def prefill_once(cfg, params, ctx, prompt, page=16):
    """Logits of one batch-1 prefill of ``prompt`` straight through
    ``models.decode.prefill``, on fresh caches."""
    from repro_torch.models import decode as D
    npages = -(-(len(prompt) + 1) // page)
    bt = torch.arange(npages, dtype=torch.int32)[None]
    caches = D.init_caches(cfg, 1, pool_slots=npages + 1, page=page, device="cuda")
    return D.prefill(params, torch.as_tensor(prompt)[None], cfg, ctx, caches, bt)[0]


def profile_prefill(name, cfg, params, ctx, prompt):
    """One full-width prefill of ``prompt`` (batch 1) under torch.profiler:
    host wall, device busy time, and the share of it that the flash and SSD
    kernels take."""
    from torch.profiler import ProfilerActivity, profile
    prefill_once(cfg, params, ctx, prompt)                 # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill_once(cfg, params, ctx, prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev)

    def share(key):
        return sum(e.self_device_time_total for e in ev if key in e.key)

    flash, ssd = share("valet::flash_"), share("valet::ssd_")
    log(f"  {name} prefill profile ({len(prompt)} tokens, batch 1): "
        f"{1e3 * wall:.3f} ms wall, device busy {busy / 1e3:.3f} ms "
        f"({100 * busy / 1e6 / wall:.1f}% of wall), {sum(e.count for e in ev)} "
        f"kernel launches; flash kernel {flash / 1e3:.3f} ms "
        f"({100 * flash / max(busy, 1):.1f}% of busy), SSD passes {ssd / 1e3:.3f} ms "
        f"({100 * ssd / max(busy, 1):.1f}%)")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d} calls  "
            f"{e.key[:90]}")


def sdpa_layout(q, k, v, *, causal=True, window=0):
    """SDPA in the flash kernel's layout (KV heads expanded, the mask as a
    boolean band): a measurement yardstick, never used by the port."""
    grp = q.shape[0] // k.shape[0]
    mask = band_mask(q.shape[1], causal, window, q.device, k.shape[1])
    return torch.nn.functional.scaled_dot_product_attention(
        q[None], k.repeat_interleave(grp, dim=0)[None],
        v.repeat_interleave(grp, dim=0)[None], attn_mask=mask)[0]


def flash_drift(name, cfg, params, ctx, prompt):
    """What the tensor-core flash route's precision (P rounded to bf16 for
    P.V) costs end to end: the last-token logits of one bf16 prefill against
    the same prefill with every flash call's q/k/v upcast to f32, which takes
    the f32 CUDA-core kernel (P in f32); SDPA in the kernel's place is the
    yardstick."""
    from repro_torch.kernels import ops
    bf16_flash = ops._flash

    def logits_with(attn):
        ops._flash = attn
        try:
            return prefill_once(cfg, params, ctx, prompt).float()
        finally:
            ops._flash = bf16_flash

    tc = logits_with(bf16_flash)
    f32 = logits_with(lambda q, k, v, **kw: bf16_flash(
        q.float(), k.float(), v.float(), **kw).to(q.dtype))
    lib = logits_with(sdpa_layout)
    real = f32.abs() < 1e29                 # the vocabulary padding holds -1e30

    def top1(x):
        return "equal" if bool(x.argmax(-1).eq(f32.argmax(-1)).all()) else "DIFFERS"

    log(f"  {name} flash precision ({len(prompt)}-token bf16 prefill): last-token "
        f"logits max abs diff against f32 flash (|logits| <= "
        f"{float(f32.abs()[real].max()):.4g}): tensor-core kernel "
        f"{max_err(tc, f32):.4e} (top-1 {top1(tc)}), sdpa {max_err(lib, f32):.4e} "
        f"(top-1 {top1(lib)})")


# Serving depths (phases 4 and 6-10), cut so that the whole run stays near
# half of its 1200 s limit: a decode step's host work grows with the layers,
# while the pool pressure is per page, so the preemptions are unchanged
GRANITE_LAYERS = 8        # phases 4 and 8
HYMBA_LAYERS = 8          # phase 6: layers 0, 3 and 7 global, the rest windowed
MAMBA2_LAYERS = 16        # phase 7
WHISPER_LAYERS = 8        # phase 10, encoder and decoder each


def phase_granite():
    from repro_torch.configs import ARCHS, replace
    from repro_torch.models import transformer as T
    log(f"phase 4: full-width granite-3-8b at {GRANITE_LAYERS} of 40 layers, f32 KV pool")
    cfg = replace(ARCHS["granite-3-8b"], n_layers=GRANITE_LAYERS)
    rng = np.random.default_rng(0)
    lens = rng.choice([128, 256, 512], size=12)
    prompts = [rng.integers(2, cfg.vocab, size=int(n)) for n in lens]
    geom = dict(max_batch=8, max_seq=576, page=16, max_new=32)
    pressured = 90            # pages; the first 8 requests alone need 120
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = T.init_params(cfg, generator=gen, dtype=dtype, device="cuda")
        n = sum(t.numel() for t in _leaves(params))
        tag = str(dtype)[6:]
        log(f"  {tag} weights and compute: params {n / 1e9:.3f} B "
            f"({n * params['embed'].element_size() / 1e9:.2f} GB)")
        ctx = T.ParallelCtx(remat=False, compute_dtype=dtype)
        if dtype == torch.bfloat16:
            # bit-identical KV bytes: repoint, stream and spill/restore must
            # give the unpressured tokens exactly.  A recompute re-prefills
            # the generated tokens with prefill-shaped products, so in bf16
            # its KV rounds differently: reported, held to exactness in f32
            runs = [(f"{tag} no pressure (512 slots)", "valet", 512, True, True),
                    (f"valet zero-restore {tag} ({pressured} slots)", "valet",
                     pressured, True, True),
                    (f"valet legacy {tag} ({pressured} slots)", "valet",
                     pressured, False, True),
                    (f"os-swap {tag} ({pressured} slots)", "os-swap", pressured,
                     True, True),
                    (f"infiniswap {tag} ({pressured} slots)", "infiniswap",
                     pressured, True, False)] + abba_tail(pressured, tag)
        else:
            runs = [(f"{tag} no pressure (512 slots)", "valet", 512, True, True),
                    (f"infiniswap {tag} ({pressured} slots)", "infiniswap",
                     pressured, True, True)]
        walls = serve_full("granite-3-8b", cfg, params, ctx, prompts, runs, **geom)
        if dtype == torch.bfloat16:
            restore_walls("granite-3-8b", walls)
            with off_path():
                profile_decode("granite-3-8b", cfg, params, ctx, prompts, **geom)
                prompt = rng.integers(2, cfg.vocab, size=512)
                profile_prefill("granite-3-8b", cfg, params, ctx, prompt)
                flash_drift("granite-3-8b", cfg, params, ctx, prompt)
        del params
        torch.cuda.empty_cache()


def phase_gemma():
    from repro_torch.configs import ARCHS, replace
    from repro_torch.models import transformer as T
    log("phase 5: full-width gemma3-4b at 6 layers (5 local + 1 global), "
        "prompts past the 1024 window")
    cfg = replace(ARCHS["gemma3-4b"], n_layers=6)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = T.init_params(cfg, generator=gen, dtype=torch.bfloat16, device="cuda")
    ctx = T.ParallelCtx(remat=False, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab, size=int(n))
               for n in rng.integers(1100, 1301, size=6)]
    serve_full("gemma3-4b", cfg, params, ctx, prompts,
               [("no pressure (400 slots)", "valet", 400, True, True),
                ("valet zero-restore (300 slots)", "valet", 300, True, True)],
               max_batch=4, max_seq=1344, page=16, max_new=16)
    del params


def pressured_slots(prompts, max_batch, page):
    """75% of the pool pages the first ``max_batch`` requests need when they
    are admitted (prompt + 1 token each), and that need."""
    need = sum(-(-(len(p) + 1) // page) for p in prompts[:max_batch])
    return int(0.75 * need), need


def exact_runs(slots, free):
    """Unpressured reference, then every policy at ``slots`` pages.  Repoint,
    stream and spill/restore move the bytes unchanged, so they must give the
    unpressured tokens exactly; infiniswap's bf16 re-prefill is reported."""
    runs = [(f"no pressure ({free} slots)", "valet", free, True, True),
            (f"valet zero-restore ({slots} slots)", "valet", slots, True, True),
            (f"valet legacy ({slots} slots)", "valet", slots, False, True),
            (f"valet-mass ({slots} slots)", "valet-mass", slots, True, True),
            (f"os-swap ({slots} slots)", "os-swap", slots, True, True),
            (f"infiniswap ({slots} slots)", "infiniswap", slots, True, False)]
    return runs


def abba_tail(slots, tag=""):
    """Legacy and zero-restore once more, in the reverse order, after a list
    that ran zero-restore then legacy: ``restore_walls`` then compares means
    in which neither pays alone for coming first."""
    t = f" {tag}" if tag else ""
    return [(f"valet legacy again{t} ({slots} slots)", "valet", slots, False, True),
            (f"valet zero-restore again{t} ({slots} slots)", "valet", slots, True, True)]


def bf16_model(name, seed, n_layers):
    from repro_torch.configs import ARCHS, replace
    from repro_torch.models import transformer as T
    cfg = replace(ARCHS[name], n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, generator=gen, dtype=torch.bfloat16, device="cuda")
    n = sum(t.numel() for t in _leaves(params))
    log(f"  bf16 weights and compute: params {n / 1e9:.3f} B ({2 * n / 1e9:.2f} GB "
        f"if all bf16; the SSM's A_log, D and dt_bias stay f32)")
    return cfg, params, T.ParallelCtx(remat=False, compute_dtype=torch.bfloat16)


def phase_hymba():
    log(f"phase 6: full-width hymba-1.5b ({HYMBA_LAYERS} of 32 layers: 3 global paged, "
        f"{HYMBA_LAYERS - 3} sliding-window rings, SSD state in every layer), bf16, f32 "
        "KV pool, prompts past the 1024 window")
    cfg, params, ctx = bf16_model("hymba-1.5b", seed=2, n_layers=HYMBA_LAYERS)
    rng = np.random.default_rng(2)
    # 1100-1300 tokens, none a multiple of the 256-step chunk
    lens = [int(n + (n % 256 == 0)) for n in rng.integers(1100, 1301, size=12)]
    prompts = [rng.integers(2, cfg.vocab, size=int(n)) for n in lens]
    geom = dict(max_batch=8, max_seq=1344, page=16)
    slots, need = pressured_slots(prompts, geom["max_batch"], geom["page"])
    log(f"  prompts {lens}; the first 8 need {need} pages, pressured at {slots}")
    walls = serve_full("hymba-1.5b", cfg, params, ctx, prompts,
                       exact_runs(slots, 1024) + abba_tail(slots), max_new=32,
                       **geom)
    restore_walls("hymba-1.5b", walls)
    with off_path():
        profile_decode("hymba-1.5b", cfg, params, ctx, prompts, pool_slots=1024, **geom)
        prompt = rng.integers(2, cfg.vocab, size=1300)
        profile_prefill("hymba-1.5b", cfg, params, ctx, prompt)
        flash_drift("hymba-1.5b", cfg, params, ctx, prompt)
        blob_cost("hymba-1.5b", cfg, params, ctx, prompts[0])
    del params
    torch.cuda.empty_cache()


def blob_cost(name, cfg, params, ctx, prompt, reps=5):
    """Wall time of one sequence's per-slot state (rings, SSD state and conv
    rings) leaving for the host tier on a pause (``DecodeBatch.save``: pinned
    copies, one synchronisation) and coming back on a resume
    (``DecodeBatch.load``), and that the round trip is exact."""
    from repro_torch.serve import ValetServeEngine
    from repro_torch.serve.batch import slot_state
    eng = ValetServeEngine(params, cfg, ctx, max_batch=1, max_seq=len(prompt) + 8,
                           page=16, pool_slots=128, device="cuda")
    rid = eng.submit(prompt, max_new=4)
    eng.step()                        # prefill + one decode step
    slot = eng._requests[rid].slot
    before = [t.clone() for t in slot_state(eng.batch.caches, slot)]
    n_bytes = sum(t.numel() * t.element_size() for t in before)
    reads, writes = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = eng.batch.save(slot)
        t1 = time.perf_counter()
        for t in slot_state(eng.batch.caches, slot):
            t.zero_()
        eng.batch.load(slot, blob)
        torch.cuda.synchronize()
        reads.append(t1 - t0)
        writes.append(time.perf_counter() - t1)
    if not all(torch.equal(t, b) for t, b in zip(slot_state(eng.batch.caches, slot), before)):
        fail(f"{name}: the per-slot state did not round-trip through the host tier")
    rd, wr = 1e3 * np.median(reads[1:]), 1e3 * np.median(writes[1:])
    log(f"  {name} per-pause state blob: {n_bytes / 1e6:.1f} MB per sequence; "
        f"to host {rd:.3f} ms ({n_bytes / rd / 1e6:.2f} GB/s), back "
        f"{wr:.3f} ms ({n_bytes / wr / 1e6:.2f} GB/s), median of {reps}; "
        f"round trip exact")


def phase_mamba2():
    log(f"phase 7: full-width mamba2-2.7b ({MAMBA2_LAYERS} of 64 layers, SSD state only, "
        "no paged layer), bf16")
    cfg, params, ctx = bf16_model("mamba2-2.7b", seed=3, n_layers=MAMBA2_LAYERS)
    rng = np.random.default_rng(3)
    lens = [int(n) for n in rng.choice([300, 700, 1000], size=12)]
    prompts = [rng.integers(2, cfg.vocab, size=n) for n in lens]
    geom = dict(max_batch=8, max_seq=1040, page=16)
    slots, need = pressured_slots(prompts, geom["max_batch"], geom["page"])
    log(f"  prompts {lens}; the first 8 need {need} pages, pressured at {slots}")
    serve_full("mamba2-2.7b", cfg, params, ctx, prompts, exact_runs(slots, 1024),
               max_new=32, **geom)
    with off_path():
        profile_decode("mamba2-2.7b", cfg, params, ctx, prompts, pool_slots=1024, **geom)
        profile_prefill("mamba2-2.7b", cfg, params, ctx,
                        rng.integers(2, cfg.vocab, size=1000))
        blob_cost("mamba2-2.7b", cfg, params, ctx, prompts[0])
    del params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Phase 8: multi-tenant serving through one host memory coordinator
# --------------------------------------------------------------------------

# KV-pool pages.  Each tenant reserves TENANT_POOL slots on the card but
# leases its effective pool from a slab of TENANT_SLAB pages, never below a
# floor of TENANT_MIN (at least one 544-token request's 34 pages).  A pool
# grows to at most half of what the coordinator says it could reach (the
# free slab, its own lease and the co-tenants' lease above their floors), so
# with two tenants a grower never asks for more than the free slab and no
# page is ever reclaimed.  With three, a grower's ask passes the free slab
# once the other two hold more than half the slab plus one floor: tenants b
# and c get 6 prompts each (about 100 pages of demand, so they grow that
# far) and finish before tenant a's 12.
TENANT_SLAB = 260
TENANT_POOL = 160
TENANT_MIN = 40
TENANT_PROMPTS = {"tenant-a": 12, "tenant-b": 6, "tenant-c": 6}
TENANT_ROUNDS = 3000


def tenant_prompts(cfg, counts, seed=0):
    """Prompts of {128, 256, 512} tokens per tenant, drawn as phase 4 draws
    its 12 (so tenant-a's are phase 4's)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, n in counts.items():
        lens = rng.choice([128, 256, 512], size=n)
        out[name] = [rng.integers(2, cfg.vocab, size=int(x)) for x in lens]
    return out


def serve_tenants(cfg, params, ctx, prompts, *, slab, weights=None):
    """One engine per tenant on one ``HostMemoryCoordinator`` of ``slab``
    pages, stepped round-robin until every one is done.  Each donation
    (``_host_donate``, called by the coordinator inside a co-tenant's lease)
    is timed between CUDA events, apart from the serving timing.  Returns
    the coordinator, the engines, each tenant's tokens and step wall
    seconds, the donation records and the round-robin's wall seconds."""
    from repro_torch.core import HostMemoryCoordinator
    from repro_torch.core.policies import POLICIES
    from repro_torch.serve import ValetServeEngine
    coord = HostMemoryCoordinator(slab)
    engines = {}
    for i, (name, ps) in enumerate(prompts.items()):
        eng = ValetServeEngine(params, cfg, ctx, max_batch=8, max_seq=576, page=16,
                               pool_slots=TENANT_POOL, min_pool=TENANT_MIN,
                               policy=POLICIES["valet"], zero_restore=True,
                               coordinator=coord, container_name=name,
                               weight=weights[i] if weights else 1.0,
                               device="cuda")
        for p in ps:
            eng.submit(p, max_new=32)
        engines[name] = eng
    donations = []

    def timed(name, donate):
        def call(n):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            got = donate(n)
            e1.record()
            donations.append((name, n, got, e0, e1))
            return got
        return call

    for rec in coord.containers():
        rec.donate_cb = timed(rec.name, rec.donate_cb)
    wall = dict.fromkeys(engines, 0.0)
    live, rounds = list(engines), 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while live:
        rounds += 1
        if rounds > TENANT_ROUNDS:
            fail(f"multi-tenant serving did not finish in {TENANT_ROUNDS} rounds")
        still = []
        for name in live:
            t1 = time.perf_counter()
            if engines[name].step():
                still.append(name)
            wall[name] += time.perf_counter() - t1
        live = still
    for name, eng in engines.items():
        t1 = time.perf_counter()
        eng._flush_demoted(None)
        wall[name] += time.perf_counter() - t1
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    outs = {}
    for name, eng in engines.items():
        reqs = sorted(eng._requests.values(), key=lambda r: r.rid)
        if not all(r.status == "done" for r in reqs):
            fail(f"{name}: requests left unfinished")
        outs[name] = [r.tokens_out for r in reqs]
    return coord, engines, outs, wall, donations, total


def phase_tenants():
    from repro_torch.configs import ARCHS, replace
    from repro_torch.models import transformer as T
    log(f"phase 8: multi-tenant serving, full-width granite-3-8b at {GRANITE_LAYERS} of 40 "
        "layers, bf16, f32 KV pool: three valet zero-restore engines leasing KV pages "
        "from one HostMemoryCoordinator, stepped round-robin")
    cfg = replace(ARCHS["granite-3-8b"], n_layers=GRANITE_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, generator=gen, dtype=torch.bfloat16, device="cuda")
    ctx = T.ParallelCtx(remat=False, compute_dtype=torch.bfloat16)
    prompts = tenant_prompts(cfg, TENANT_PROMPTS)
    log(f"  slab {TENANT_SLAB} pages, {TENANT_POOL} slots reserved per tenant, "
        f"floor {TENANT_MIN}; prompts per tenant "
        f"{ {n: [len(p) for p in ps] for n, ps in prompts.items()} }")
    torch.cuda.reset_peak_memory_stats()
    problems = []
    solo = {}
    for name, ps in prompts.items():
        outs, st, wall = run_engine(params, cfg, ctx, ps, policy="valet", pool_slots=512,
                                    max_batch=8, max_seq=576, page=16, max_new=32,
                                    device="cuda")
        solo[name] = outs
        n_tok = sum(len(o) for o in outs)
        log(f"  {name} alone, no pressure (512 slots): {n_tok} tokens in {wall:.3f} s "
            f"wall ({n_tok / wall:.2f} tok/s on this card); {stats_line(st)}")
    coord, engines, outs, wall, donations, total = serve_tenants(
        cfg, params, ctx, prompts, slab=TENANT_SLAB)
    n_all = 0
    for name, eng in engines.items():
        n_tok = sum(len(o) for o in outs[name])
        n_all += n_tok
        log(f"  {name} coordinated: {n_tok} tokens in {wall[name]:.3f} s of its steps' "
            f"wall ({n_tok / wall[name]:.2f} tok/s on this card); {stats_line(eng.stats)}")
        if outs[name] != solo[name]:
            diff = sum(a != b for a, b in zip(outs[name], solo[name]))
            problems.append(f"{name}: tokens differ from its solo run in {diff} of "
                            f"{len(outs[name])} requests")
        else:
            log(f"  {name}: tokens identical to its solo unpressured run")
    log(f"  round-robin: {n_all} tokens in {total:.3f} s wall "
        f"({n_all / total:.2f} tok/s on this card, all tenants)")
    problems += tenant_books(coord, engines)
    if not any(e.stats.pauses > 0 and e.stats.repointed_pages > 0
               for e in engines.values()):
        problems.append("no tenant was preempted and repointed")
    torch.cuda.synchronize()
    ms = [e0.elapsed_time(e1) for _, _, _, e0, e1 in donations]
    log(f"  donation flushes: {len(donations)} calls, "
        f"{sum(d[2] for d in donations)} pages shed, {sum(ms):.3f} ms between CUDA "
        f"events in all (max {max(ms, default=0.0):.3f} ms); by donor "
        f"{ {n: sum(d[2] for d in donations if d[0] == n) for n in engines} }")
    if not donations or coord.stats.pages_reclaimed <= 0:
        problems.append("no donation: CoordinatorStats.pages_reclaimed is 0")

    # QoS weights: a light (1) and a heavy (3) tenant serve, then a third
    # container registers and leases one floor more; the weighted-fair pass
    # sheds the light tenant toward its smaller share first
    light_heavy = {"light": prompts["tenant-b"], "heavy": prompts["tenant-c"]}
    coord, engines, outs, wall, donations, total = serve_tenants(
        cfg, params, ctx, light_heavy, slab=TENANT_SLAB, weights=(1.0, 3.0))
    before = {r.name: r.leased for r in coord.containers()}
    hog = coord.register(min_pages=TENANT_MIN, max_pages=TENANT_SLAB, name="hog")
    hog.lease(TENANT_MIN)
    recs = {r.name: r for r in coord.containers()}
    log(f"  weights 1 / 3: leases {before} after serving, "
        f"{ {n: recs[n].leased for n in before} } after a third container "
        f"registered and leased {TENANT_MIN} pages more; fair shares "
        f"{ {n: coord.fair_share(recs[n].cid) for n in before} }")
    problems += tenant_books(coord, engines)
    for name, src in (("light", "tenant-b"), ("heavy", "tenant-c")):
        if outs[name] != solo[src]:
            problems.append(f"weighted {name}: tokens differ from its solo run")
    if not recs["light"].leased <= recs["heavy"].leased:
        problems.append("weighted: the light tenant holds a larger lease than the heavy")
    if not sum(before.values()) > recs["light"].leased + recs["heavy"].leased:
        problems.append("weighted: no pages were reclaimed from the tenants")
    log(f"  multi-tenant: torch.cuda.max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    if problems:
        fail("multi-tenant: " + "; ".join(problems))


def tenant_books(coord, engines):
    """Print the coordinator's records and stats, check its invariants and
    that every tenant's lease equals its pool's size; the problems found."""
    for rec in coord.containers():
        log(f"    {rec.name}: leased {rec.leased} (floor {rec.min_pages}, cap "
            f"{rec.max_pages}, weight {rec.weight}), demand {rec.demand:.3f}, "
            f"leases {rec.n_leases}, pages leased {rec.pages_leased_total}, "
            f"donated {rec.pages_donated_total}")
    log(f"    {coord.stats}")
    problems = []
    try:
        coord.check_invariants()
    except AssertionError as e:
        problems.append(f"coordinator invariants: {e}")
    for rec in coord.containers():
        if rec.name in engines and rec.leased != engines[rec.name].pool.size:
            problems.append(f"{rec.name}: leased {rec.leased} != pool size "
                            f"{engines[rec.name].pool.size}")
    return problems


# --------------------------------------------------------------------------
# Phase 9: deepseek-moe-16b served under pressure
# --------------------------------------------------------------------------

MOE_LAYERS = 6            # 1 dense + 5 MoE layers of 28, full width


def moe_row_check(cfg, params):
    """One MoE layer's decode FFN (``moe_ffn`` over the (8, 1, d) batch the
    engine's decode step routes, capacity 8, so nothing drops): row 0's
    output must keep its bits with the other 7 rows zero ("alone"), with
    them holding other states, and on a repeat.  A batch-1 call, a shape
    the engine never issues, is reported beside it."""
    from repro_torch.models.decode import layer_infos, layer_params
    from repro_torch.models.moe import capacity, moe_ffn
    info = next(i for i in layer_infos(cfg) if i.ffn == "moe")
    p = layer_params(params, info)["moe"]
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = torch.randn((8, 1, cfg.d_model), device="cuda", generator=g).to(torch.bfloat16)
    alone = torch.zeros_like(batch)
    alone[0] = batch[0]
    out_alone = moe_ffn(p, alone, cfg.moe)[0][0]
    out_batch = moe_ffn(p, batch, cfg.moe)[0][0]
    out_again = moe_ffn(p, batch.clone(), cfg.moe)[0][0]
    out_one = moe_ffn(p, batch[:1], cfg.moe)[0][0]
    torch.cuda.synchronize()
    for what, other in (("inside the batch of 8", out_batch), ("on a repeat", out_again)):
        if not torch.equal(out_alone, other):
            fail(f"moe row independence: row 0 alone differs from row 0 {what} "
                 f"(max abs diff {max_err(out_alone, other):.3e})")
    one = ("bit-identical" if torch.equal(out_one, out_alone)
           else f"max abs diff {max_err(out_one, out_alone):.3e}")
    log(f"  moe decode row check (layer {info.seg}.{info.idx}, capacity "
        f"{capacity(8, cfg.moe)} of 8 rows x top-{cfg.moe.top_k}): row 0 bit-identical "
        f"alone (7 zero rows), inside the batch of 8 and on a repeat; a batch-1 "
        f"call (not an engine shape): {one}")


def phase_deepseek():
    from repro_torch.configs import ARCHS, replace
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import capacity
    log(f"phase 9: full-width deepseek-moe-16b at {MOE_LAYERS} of 28 layers (1 dense + "
        f"{MOE_LAYERS - 1} MoE: 64 experts of 1408, top-6, 2 shared), bf16, f32 KV pool")
    cfg = replace(ARCHS["deepseek-moe-16b"], n_layers=MOE_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = T.init_params(cfg, generator=gen, dtype=torch.bfloat16, device="cuda")
    n = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"  params {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B ({n / 1e9:.2f} GB; "
        f"the routers f32)")
    ctx = T.ParallelCtx(remat=False, compute_dtype=torch.bfloat16)
    with off_path():
        moe_row_check(cfg, params)
    rng = np.random.default_rng(4)
    lens = rng.choice([128, 256, 512], size=12)
    prompts = [rng.integers(2, cfg.vocab, size=int(x)) for x in lens]
    geom = dict(max_batch=8, max_seq=576, page=16)
    slots, need = pressured_slots(prompts, geom["max_batch"], geom["page"])
    log(f"  prompts {[int(x) for x in lens]}; the first 8 need {need} pages, pressured "
        f"at {slots}; a decode step routes its 8 rows at capacity "
        f"{capacity(geom['max_batch'], cfg.moe)}, so it drops nothing")
    walls = serve_full("deepseek-moe-16b", cfg, params, ctx, prompts,
                       exact_runs(slots, 512) + abba_tail(slots), max_new=32, **geom)
    restore_walls("deepseek-moe-16b", walls)
    log("  (infiniswap is reported, not held: its re-prefill routes prompt and "
        "generated tokens in one call, so its capacity and drops differ from the "
        "first prefill's, and in bf16 it recomputes KV with other products)")
    with off_path():
        profile_decode("deepseek-moe-16b", cfg, params, ctx, prompts, **geom)
        profile_prefill("deepseek-moe-16b", cfg, params, ctx,
                        rng.integers(2, cfg.vocab, size=512))
    del params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Phase 10: llama-3.2-vision and whisper, prefill and decode
# --------------------------------------------------------------------------

CROSS_BATCH = 4
CROSS_NEW = 16
# decode against the full forward in f32.  The CPU test holds 5e-2, but at
# these logits another frontend moves them by only ~2e-2, so the card holds
# 1e-3 (the gaps measured were 4.7e-5 and 6.3e-6) and also holds the gap to
# a tenth of the frontend's effect: a step that read zeroed or stale cross
# K/V would fail both.
CROSS_TOL = 1e-3


def decode_rows(params, cfg, ctx, prompts, frontend, *, page=16, forced=None, check=False):
    """Prefill each prompt alone (batch 1, as the engine does) into shared
    page pools and its row's cross K/V, then decode every row together for
    ``CROSS_NEW`` steps straight through ``models.decode``: greedy, or fed
    the tokens of ``forced`` (B, CROSS_NEW).  With ``check``, the prefill's
    and every step's logits are held against ``prefill_logits`` of each
    row's sequence so far (off the main path).  Returns the fed tokens
    (B, CROSS_NEW), the logits of the prefill and of every step
    (CROSS_NEW + 1, B, V), and the largest difference from the forward."""
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    b, v = len(prompts), cfg.vocab
    n_pages = -(-(max(len(p) for p in prompts) + CROSS_NEW) // page) + 1
    bt = torch.arange(b * n_pages, dtype=torch.int32, device="cuda").reshape(b, n_pages)
    caches = D.init_caches(cfg, b, pool_slots=b * n_pages, page=page, device="cuda")
    seqs, first = [list(map(int, p)) for p in prompts], []
    for i, p in enumerate(prompts):
        one = D.init_caches(cfg, 1, pool_slots=1, page=page, device="cuda")
        for oc, bc in zip(one["layers"], caches["layers"]):
            if "pool" in bc:
                oc["pool"] = bc["pool"]
        lg, one = D.prefill(params, torch.as_tensor(p, device="cuda")[None], cfg, ctx,
                            one, bt[i:i + 1], frontend=frontend[i:i + 1])
        for oc, bc in zip(one["layers"], caches["layers"]):
            for key in ("cross_k", "cross_v"):
                if key in bc:
                    bc[key][i].copy_(oc[key][0])
        first.append(lg[0])
    caches["lengths"] = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                                     device="cuda")
    logits = torch.stack(first)
    steps, fed, worst = [logits], [], 0.0

    def held(lg):
        nonlocal worst
        with off_path():
            for i in range(b):
                full = T.prefill_logits(params, torch.as_tensor(seqs[i], device="cuda")[None],
                                        cfg, ctx, frontend=frontend[i:i + 1])
                worst = max(worst, max_err(full[0, :v], lg[i, :v]))

    if check:
        held(logits)
    rows = torch.arange(b, device="cuda")
    for t in range(CROSS_NEW):
        nxt = logits.argmax(-1) if forced is None else forced[:, t]
        fed.append(nxt)
        pos = torch.as_tensor([len(sq) for sq in seqs], device="cuda")
        for sq, tok in zip(seqs, nxt.tolist()):
            sq.append(tok)
        logits, caches = D.decode_step(params, caches, nxt, cfg, ctx, bt,
                                       bt[rows, pos // page], pos % page)
        steps.append(logits)
        if check:
            held(logits)
    return torch.stack(fed, 1), torch.stack(steps), worst


def to_bf16(params):
    """A bf16 copy of an f32 tree; the reference's f32 leaves stay f32."""
    from repro_torch.bridge import F32_LEAVES

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(x, k) for k, x in t.items()}
        if isinstance(t, list):
            return [walk(x) for x in t]
        return t if key in F32_LEAVES else t.to(torch.bfloat16)
    return walk(params)


def cross_arch(name, cfg, seed, what):
    """One cross-attention arch at full width: f32 with TF32 off, held
    against its full forward, the frontend's effect, then the bf16 run's
    drift from f32 on the same tokens."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, generator=gen, dtype=torch.float32, device="cuda")
    n = sum(t.numel() for t in _leaves(params))
    gates = open_gates(params)
    log(f"  {name}: {what}; params {n / 1e9:.3f} B"
        + ("; xgate set to 1.0 in every xattn layer (0 at init shuts the cross path)"
           if gates else ""))
    rng = np.random.default_rng(seed)
    lens = sorted(int(x) for x in rng.integers(64, 257, size=CROSS_BATCH))
    prompts = [rng.integers(2, cfg.vocab, size=x) for x in lens]
    fg = torch.Generator(device="cuda").manual_seed(seed + 100)
    shape = (CROSS_BATCH, cfg.n_frontend_tokens, cfg.d_model)
    frontend = torch.randn(shape, device="cuda", generator=fg)
    other = torch.randn(shape, device="cuda", generator=fg)
    ctx32 = T.ParallelCtx(remat=False, compute_dtype=torch.float32)
    t0 = time.perf_counter()
    toks, logits32, worst = decode_rows(params, cfg, ctx32, prompts, frontend, check=True)
    torch.cuda.synchronize()
    log(f"  {name} f32: prompts {lens} + {CROSS_NEW} new, frontend {tuple(shape)}; "
        f"prefill and {CROSS_NEW} decode steps against the full forward "
        f"(prefill_logits on each row's sequence so far): max abs diff {worst:.3e} "
        f"(tol {CROSS_TOL}; |logits| <= {float(logits32[..., :cfg.vocab].abs().max()):.3g}); "
        f"{time.perf_counter() - t0:.1f} s with the checks")
    if not worst <= CROSS_TOL:
        fail(f"{name}: decode logits differ from the full forward by {worst:.3e}")
    if not torch.isfinite(logits32[..., :cfg.vocab]).all():
        fail(f"{name}: non-finite logits")
    with off_path():
        a = T.prefill_logits(params, torch.as_tensor(prompts[0], device="cuda")[None], cfg,
                             ctx32, frontend=frontend[:1])
        b = T.prefill_logits(params, torch.as_tensor(prompts[0], device="cuda")[None], cfg,
                             ctx32, frontend=other[:1])
    moved = max_err(a[:, :cfg.vocab], b[:, :cfg.vocab])
    log(f"  {name}: another frontend moves row 0's prefill logits by up to {moved:.3e}")
    if not moved > 1e-3:
        fail(f"{name}: the frontend does not reach the logits ({moved:.3e})")
    log(f"  {name}: the decode's gap from the full forward is "
        f"{worst / moved:.2e} of the frontend's effect (limit 0.1)")
    if not worst <= 0.1 * moved:
        fail(f"{name}: decode gap {worst:.3e} is over a tenth of the frontend's "
             f"effect {moved:.3e}")
    p16 = to_bf16(params)
    del params
    ctx16 = T.ParallelCtx(remat=False, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    _, logits16, _ = decode_rows(p16, cfg, ctx16, prompts, frontend, forced=toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    real = logits16[..., :cfg.vocab].float()
    if not torch.isfinite(real).all():
        fail(f"{name}: non-finite bf16 logits")
    top1 = float((real.argmax(-1) == logits32[..., :cfg.vocab].argmax(-1)).float().mean())
    log(f"  {name} bf16 (fed the f32 run's tokens): drift from f32 max abs "
        f"{max_err(real, logits32[..., :cfg.vocab]):.3e}, top-1 agreement "
        f"{100 * top1:.1f}% over {real.shape[0] * real.shape[1]} positions; prefill + "
        f"{CROSS_NEW} steps {wall:.3f} s wall")
    del p16
    torch.cuda.empty_cache()


def phase_cross():
    from repro_torch.configs import ARCHS, replace
    log("phase 10: cross-attention archs at full width, prefill + decode_step straight "
        f"through models.decode, batch {CROSS_BATCH}, f32 pools")
    cross_arch("llama-3.2-vision-11b", replace(ARCHS["llama-3.2-vision-11b"], n_layers=10),
               seed=6, what="10 of 40 layers (2 x [4 attn + 1 xattn]), 6656 patch tokens")
    cross_arch("whisper-large-v3", replace(ARCHS["whisper-large-v3"], n_layers=WHISPER_LAYERS,
                                           encoder_layers=WHISPER_LAYERS), seed=7,
               what=f"{WHISPER_LAYERS} of 32 encoder + {WHISPER_LAYERS} of 32 decoder "
                    "layers, 1536 frames")


# --------------------------------------------------------------------------
# Phase 11: training
# --------------------------------------------------------------------------

TRAIN_STEPS = 10
TRAIN_SEQ = 1024
TRAIN_MICRO, TRAIN_MB = 2, 4          # a global batch of 8 sequences
# the peak learning rate of the full-width runs: the order of the published
# rates at these sizes.  The reference's reduced-model test uses 1e-3; at
# full width that spiked both models' loss right after the warmup, and
# mamba2's last loss ended above its first (PERF.md, phase 11 findings)
TRAIN_LR = 3e-4
GRAD_CHECK_TOL = 1e-4                 # of each gradient leaf's largest entry
MEMORY_LIMIT = 80e9


def train_config(dtype=torch.bfloat16, **adamw):
    from repro_torch import optim
    from repro_torch.train import TrainConfig
    adamw = adamw or dict(lr=TRAIN_LR, warmup_steps=5, total_steps=60)
    return TrainConfig(microbatches=TRAIN_MICRO, compute_dtype=dtype,
                       grad_dtype=torch.float32, adamw=optim.AdamWConfig(**adamw))


def model_flops(cfg, params, tokens):
    """Model FLOPs of one training step over ``tokens`` tokens: 6 N T, N the
    parameters the forward multiplies (all but the input embedding table,
    which it gathers), plus attention's 12 L Hq D S per token (forward and
    backward over every key, PaLM's count).  The SSD scan's mixing is left
    out."""
    from repro_torch.models import transformer as T
    n = sum(t.numel() for t in _leaves(params))
    n_mm = n - (0 if cfg.tie_embeddings else params["embed"].numel())
    attn_layers = sum(seg.count for seg in T.segments(cfg) if seg.kind != "ssm")
    attn = 12 * attn_layers * cfg.n_heads * cfg.resolved_head_dim * TRAIN_SEQ
    return n, (6 * n_mm + attn) * tokens


def profile_step(fn):
    """One call of ``fn`` under torch.profiler (device activity only): (its
    result, device busy ms, kernel launches, the kernels by device time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: -e.self_device_time_total)
    return (out, sum(e.self_device_time_total for e in ev) / 1e3,
            sum(e.count for e in ev), ev)


def train_full(name, cfg, seed):
    """``TRAIN_STEPS`` steps of the port's ``make_train_step`` on ``cfg`` at
    full width: bf16 compute, f32 grads and masters, remat, AdamW with the
    reference's ``test_loss_decreases`` warmup and decay at ``TRAIN_LR``,
    data from ``TrainDataset``.
    Held: finite losses and grad norms, every parameter leaf moved, the last
    loss below the first, peak allocated memory under 80 GB.  The last step
    runs under the profiler (device time, launches) and is left out of the
    wall median."""
    from repro_torch import optim
    from repro_torch.bridge import tree_flatten
    from repro_torch.data import DataConfig, TrainDataset
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import transformer as T
    from repro_torch.train import make_train_step
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, generator=gen, dtype=torch.float32, device="cuda")
    tokens = TRAIN_MICRO * TRAIN_MB * TRAIN_SEQ
    n, flops = model_flops(cfg, params, tokens)
    log(f"  {name}: {cfg.n_layers} layers at full width, {n / 1e9:.3f} B params; "
        f"{TRAIN_MICRO} microbatches of {TRAIN_MB} x {TRAIN_SEQ}, bf16 compute, f32 "
        f"grads, remat; model FLOPs {flops:.3e} per step")
    ctx = T.ParallelCtx(remat=True, compute_dtype=torch.bfloat16)
    step = make_train_step(cfg, ctx, train_config())
    state = optim.init(params)
    ds = TrainDataset(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_MICRO * TRAIN_MB, seed=seed))
    marks = [t.reshape(-1)[:64].clone() for t in tree_flatten(params)[0]]
    torch.cuda.reset_peak_memory_stats()
    losses, norms, walls = [], [], []
    for i in range(TRAIN_STEPS):
        toks, labels = (torch.as_tensor(a, device="cuda").reshape(
            TRAIN_MICRO, TRAIN_MB, TRAIN_SEQ) for a in next(ds))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = lambda: step(params, state, toks, labels)
        if i == TRAIN_STEPS - 1:
            ssd_before = ssd.ssd_scan.launches
            (params, state, m), busy, launches, kernels = profile_step(run)
            ssd_step = ssd.ssd_scan.launches - ssd_before
        else:
            params, state, m = run()
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        walls.append(time.perf_counter() - t0)
        log(f"    step {i}: loss {losses[-1]:.4f} grad norm {norms[-1]:.4f} lr "
            f"{float(m['lr']):.3e} wall {1e3 * walls[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    wall = float(np.median(walls[1:-1]))
    moved = sum(not torch.equal(a, t.reshape(-1)[:64])
                for a, t in zip(marks, tree_flatten(params)[0]))
    log(f"  {name}: step wall {1e3 * wall:.1f} ms (median of steps 1-{TRAIN_STEPS - 2}); "
        f"profiled step device busy {busy:.1f} ms ({100 * busy / 1e3 / wall:.1f}% "
        f"of the median wall; {1e3 * walls[-1]:.1f} ms under the profiler), "
        f"{launches} kernel launches, "
        f"{ssd_step} SSD scan launches; {tokens / wall:.0f} tokens/s; model FLOPs "
        f"{flops / wall / 1e12:.1f} TFLOP/s = {100 * flops / wall / PEAK_FLOPS[torch.bfloat16]:.1f}% "
        f"of 989 (by device busy: {100 * flops / (busy / 1e3) / PEAK_FLOPS[torch.bfloat16]:.1f}%); "
        f"peak allocated {peak / 1e9:.2f} GB; {moved} of {len(marks)} parameter leaves moved")
    for e in kernels[:8]:
        key = e.key.replace("void ", "").replace("at::native::", "").replace("std::", "")
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d} calls  {key[:130]}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        fail(f"{name} training: non-finite loss or grad norm")
    if moved != len(marks):
        fail(f"{name} training: {len(marks) - moved} parameter leaves did not move")
    if not losses[-1] < losses[0]:
        fail(f"{name} training: loss did not fall ({losses[0]:.4f} -> {losses[-1]:.4f})")
    if not peak < MEMORY_LIMIT:
        fail(f"{name} training: peak allocated {peak / 1e9:.2f} GB")
    del params, state, m
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_scan():
    """``ssm_forward`` with ``ssd_chunked`` in place of the kernel's op, so
    that autograd differentiates the plain scan directly."""
    from repro_torch.models import ssm
    real = ssm.ssd_scan_op

    def plain(x, dt, A, B_mat, C_mat, *, chunk):
        zeros = torch.zeros((x.shape[2],), dtype=torch.float32, device=x.device)
        return ssm.ssd_chunked(x, dt, A, B_mat, C_mat, zeros, chunk)
    ssm.ssd_scan_op = plain
    try:
        yield
    finally:
        ssm.ssd_scan_op = real


def loss_and_grads(params, cfg, ctx, toks, labels):
    from repro_torch.bridge import tree_flatten, tree_unflatten
    from repro_torch.models import transformer as T
    leaves, structure = tree_flatten(params)
    leaves = [a.detach().requires_grad_() for a in leaves]
    loss = T.lm_loss(tree_unflatten(structure, leaves), toks, labels, cfg, ctx)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def ssd_grad_check(seed=11):
    """Loss and every gradient of 2 full-width mamba2 layers in f32 (TF32
    off) with the scan on the kernel's ``SSDScan`` against the same loss
    with ``ssd_chunked`` differentiated directly on the card."""
    from repro_torch.configs import ARCHS, replace
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import transformer as T
    cfg = replace(ARCHS["mamba2-2.7b"], n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, generator=gen, dtype=torch.float32, device="cuda")
    ctx = T.ParallelCtx(remat=False, compute_dtype=torch.float32)
    rng = np.random.default_rng(seed)
    toks, labels = (torch.as_tensor(rng.integers(0, cfg.vocab, (2, TRAIN_SEQ)),
                                    device="cuda") for _ in range(2))
    before = ssd.ssd_scan.launches
    lk, gk = loss_and_grads(params, cfg, ctx, toks, labels)
    launched = ssd.ssd_scan.launches - before
    with plain_scan():
        lp, gp = loss_and_grads(params, cfg, ctx, toks, labels)
    if ssd.ssd_scan.launches - before != launched or launched != cfg.n_layers:
        fail(f"ssd gradient check: {launched} kernel launches for {cfg.n_layers} layers")
    names = ["/".join(map(str, k)) for k in _paths(params)]
    gaps = [(max_err(a, b) / max(float(b.abs().max()), 1e-30), nm)
            for a, b, nm in zip(gk, gp, names)]
    worst, where = max(gaps)
    loss_gap = abs(float(lk) - float(lp)) / abs(float(lp))
    ssm_gaps = ", ".join(f"{nm.split('/')[-1]} {g:.2e}" for g, nm in gaps if "/ssm/" in nm)
    log(f"  ssd gradient check (mamba2, 2 full-width layers, f32, S {TRAIN_SEQ}, "
        f"batch 2): loss {float(lk):.6f} against {float(lp):.6f} (rel {loss_gap:.2e}); "
        f"worst gradient gap {worst:.3e} of its leaf's largest entry ({where}); "
        f"SSM leaves: {ssm_gaps} (limit {GRAD_CHECK_TOL})")
    if not (worst <= GRAD_CHECK_TOL and loss_gap <= GRAD_CHECK_TOL):
        fail(f"ssd gradient check: gap {worst:.3e} at {where}, loss {loss_gap:.3e}")
    del params, gk, gp
    torch.cuda.empty_cache()


def _paths(tree, prefix=()):
    """Key paths of ``tree``'s leaves, in ``tree_flatten`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix


def train_reduced():
    """One reduced f32 train step of every arch (2 microbatches, remat on)
    on the card against the CPU: loss and grad norm within 1e-5, first
    moments within 1e-4 of each leaf's largest entry, updated params within
    1e-3 lr where |g| >= 100 eps and within 2 lr below (the step moves an
    entry by lr g / (|g| + eps), which a rounding of a gradient near eps
    moves by up to lr)."""
    from repro_torch import optim
    from repro_torch.bridge import tree_flatten
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import transformer as T
    from repro_torch.train import make_train_step
    lr = 1e-3
    ctx = T.ParallelCtx(remat=True, q_block=8, kv_block=8, loss_chunk=8)
    worst = {}
    for name in sorted(ARCHS):
        cfg = reduced(ARCHS[name])
        params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
        open_gates(params)
        rng = np.random.default_rng(0)
        toks, labels = (torch.as_tensor(rng.integers(0, cfg.vocab, (2, 2, 24)))
                        for _ in range(2))
        fe = None
        if cfg.n_frontend_tokens:
            fe = torch.randn((2, 2, cfg.n_frontend_tokens, cfg.d_model),
                             generator=torch.Generator().manual_seed(1))
        step = make_train_step(cfg, ctx, train_config(
            torch.float32, lr=lr, warmup_steps=0), has_frontend=fe is not None)
        outs = []
        for dev in ("cpu", "cuda"):
            p = to_device(params, dev)
            args = [p, optim.init(p), toks.to(dev), labels.to(dev)]
            outs.append(step(*args, *([] if fe is None else [fe.to(dev)])))
        (cp, cs, cm), (gp, gs, gm) = outs
        gaps = [abs(float(gm[k]) - float(cm[k])) / abs(float(cm[k]))
                for k in ("loss", "grad_norm")]
        # each entry's gap over its tolerance (<= 1 holds)
        p_gap = max(float(((b.cpu() - a).abs() / torch.where(
            mu.abs() / 0.1 >= 1e-6, 1e-3 * lr, 2 * lr)).max())
            for a, b, mu in zip(tree_flatten(cp)[0], tree_flatten(gp)[0],
                                tree_flatten(cs.mu)[0]))
        m_gap = max(max_err(a, b.cpu()) / max(float(a.abs().max()), 1e-30)
                    for a, b in zip(tree_flatten(cs.mu)[0], tree_flatten(gs.mu)[0]))
        worst[name] = (max(gaps), p_gap, m_gap)
        if not (max(gaps) <= 1e-5 and p_gap <= 1 and m_gap <= 1e-4):
            fail(f"{name} reduced train step: CUDA differs from CPU (loss/norm "
                 f"{max(gaps):.2e}, params {p_gap:.2e} of their tolerance, "
                 f"moments {m_gap:.2e})")
    log("  reduced train step, CUDA against CPU (loss/grad norm rel, params' worst "
        "gap over its tolerance, first moment of leaf max): " + "; ".join(
            f"{n} {a:.1e}/{b:.1e}/{c:.1e}" for n, (a, b, c) in worst.items()))


def bits(t):
    """A tensor's bytes as integers of its element size (NaN-safe equality)."""
    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def checkpoint_round_trip(seed=12):
    """A (f32 masters, bf16 compute copy, AdamW state) snapshot of one
    full-width mamba2 layer (vocab cut to 4096: ~0.85 GB) through
    ``ValetCheckpointer`` under a temporary directory: staging time, bytes
    equal after ``restore_tensors``, and a step resumed from the restored
    state against the uninterrupted step (bit for bit if two uninterrupted
    steps agree bit for bit, else within f32 tolerance)."""
    import shutil
    import tempfile
    from repro_torch import optim
    from repro_torch.bridge import tree_flatten
    from repro_torch.configs import ARCHS, replace
    from repro_torch.models import transformer as T
    from repro_torch.train import ValetCheckpointer, cast_for_compute, make_train_step
    cfg = replace(ARCHS["mamba2-2.7b"], n_layers=1, vocab=4096)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, generator=gen, dtype=torch.float32, device="cuda")
    step = make_train_step(cfg, T.ParallelCtx(remat=True, compute_dtype=torch.bfloat16),
                           train_config(lr=TRAIN_LR, warmup_steps=0))
    rng = np.random.default_rng(seed)
    batches = [torch.as_tensor(rng.integers(0, cfg.vocab, (TRAIN_MICRO, 2, TRAIN_SEQ)),
                               device="cuda") for _ in range(4)]
    p1, s1, _ = step(params, optim.init(params), batches[0], batches[1])
    tree = {"params": p1, "compute": cast_for_compute(p1, torch.bfloat16), "opt": s1}
    leaves = tree_flatten(tree)[0]
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    d = tempfile.mkdtemp(prefix="valet_ckpt_")
    try:
        ckpt = ValetCheckpointer(d, replicas=2, keep=2)
        staged = ckpt.save(1, tree)
        t0 = time.perf_counter()
        ckpt.close()
        written = time.perf_counter() - t0
        got_step, got = ValetCheckpointer(d, replicas=2).restore_tensors(
            "cuda", tree_like=tree)
        got_leaves = tree_flatten(got)[0]
        same = got_step == 1 and len(got_leaves) == len(leaves) and all(
            a.dtype == b.dtype and torch.equal(bits(a), bits(b))
            for a, b in zip(leaves, got_leaves))
        dtypes = sorted({str(t.dtype).replace("torch.", "") for t in leaves})
        log(f"  checkpoint: {len(leaves)} leaves ({', '.join(dtypes)}), "
            f"{n_bytes / 1e9:.3f} GB; save() staged it in {1e3 * staged:.1f} ms "
            f"({n_bytes / staged / 1e9:.2f} GB/s to host), the writer took "
            f"{1e3 * written:.1f} ms more for 2 replicas; restore bit-equal: {same}")
        if not same:
            fail("checkpoint: the restored snapshot differs from the saved one")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    again = [step(p1, s1, batches[2], batches[3]) for _ in range(2)]
    resumed = step(got["params"], got["opt"], batches[2], batches[3])
    flat = [tree_flatten((p, s, m["loss"]))[0] for p, s, m in again + [resumed]]
    deterministic = all(torch.equal(bits(a), bits(b)) for a, b in zip(flat[0], flat[1]))
    gap = max(max_err(a, b) / max(float(a.abs().max()), 1e-30)
              for a, b in zip(flat[0], flat[2]))
    exact = all(torch.equal(bits(a), bits(b)) for a, b in zip(flat[0], flat[2]))
    log(f"  resume: two uninterrupted steps agree bit for bit: {deterministic}; the "
        f"step from the restored state against the uninterrupted one: bit-equal "
        f"{exact}, worst gap {gap:.2e} of a leaf's largest entry")
    if not (exact if deterministic else gap <= 1e-5):
        fail(f"checkpoint: the resumed step differs (gap {gap:.2e})")
    del params, p1, s1, tree, got, again, resumed
    torch.cuda.empty_cache()


def phase_training():
    from repro_torch.configs import ARCHS, replace
    log("phase 11: training (make_train_step: bf16 compute, microbatches, AdamW), "
        f"{TRAIN_STEPS} steps at full width; f32 checks with TF32 off")
    train_full("granite-3-8b", replace(ARCHS["granite-3-8b"], n_layers=8), seed=8)
    train_full("mamba2-2.7b", replace(ARCHS["mamba2-2.7b"], n_layers=16), seed=9)
    with off_path():
        ssd_grad_check()
        train_reduced()
        checkpoint_round_trip()


# --------------------------------------------------------------------------
# Phase 12: the sharded serve step
# --------------------------------------------------------------------------

# Full-width granite-3-8b at 4 of 40 layers and gemma3-4b at 6 of 34 (5
# local + 1 global), f32, batch 8: each row is fed a prompt of 64-128
# tokens one token per step, then its own argmax for SHARD_NEW steps (rows
# with shorter prompts generate more, as the batch steps together).
SHARD_ARCHS = (("granite-3-8b", 4, 2), ("gemma3-4b", 6, 3))   # name, layers, seed
SHARD_BATCH, SHARD_NEW, SHARD_PAGE = 8, 32, 16
SHARD_PROMPTS = (64, 128)   # cut from 64-256 to fit the phase's 120 s
SHARD_TOL = 1e-4            # of the largest logit of (b)'s step (real vocab)
SHARD_MESH = (2, 2)         # (c): data x model ranks sharing the card
SHARD_SECONDS = 300         # (c)'s ranks fail past this
# (a)'s shapes: (hq, hkv, d, max_len, n_pages), batches, kvrs.  Granite's
# heads over rows of up to 576 tokens (the timed case: B 8, kvr 2, f32),
# then the launches of (b) and (c): B 8 on one rank, B 4 per data rank on
# two KV ranks, tables of 10 pages (160 steps), granite and gemma3's global
# layer
PARTIAL_SHAPES = (((32, 8, 128, 576, None), (8,), (2, 4, 8)),
                  ((32, 8, 128, 160, 10), (8, 4), (1, 2)),
                  ((8, 4, 256, 160, 10), (8, 4), (1, 2)))


def shard_prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(SHARD_PROMPTS[0], SHARD_PROMPTS[1] + 1, size=SHARD_BATCH)
    return [rng.integers(2, cfg.vocab, size=int(n)) for n in lens]


def shard_geometry(cfg, mesh, n_steps):
    """The decode shape, plan and global step inputs of a run of ``n_steps``
    steps from length 0: page pg of a row on KV rank pg % kvr as local page
    pg // kvr, slots handed out in order per (data, KV) rank."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve_step as SS
    shape = ShapeConfig("chip_smoke", seq_len=n_steps, global_batch=SHARD_BATCH,
                        kind="decode")
    plan = SS.DecodePlan(batch_axes=("data",), kv_axes=("model",), page=SHARD_PAGE)
    geo = SS.cache_geometry(cfg, shape, mesh, plan)
    dp, kvr, b_loc = geo["dp"], geo["kvr"], geo["b_loc"]
    bt = np.full((dp, kvr, b_loc, geo["p_loc"]), -1, np.int32)
    used = np.zeros((dp, kvr), int)
    for b in range(SHARD_BATCH):
        for pg in range(geo["p_tot"]):
            d, r = b // b_loc, pg % kvr
            bt[d, r, b % b_loc, pg // kvr] = used[d, r]
            used[d, r] += 1
    assert used.max() <= geo["slots_loc"]
    return shape, plan, bt


def shard_step(bt, t, tokens, kvr):
    """Global step inputs of step t (every row at length t)."""
    b_loc = bt.shape[2]
    pg = t // SHARD_PAGE
    rank = pg % kvr
    slot = np.array([bt[b // b_loc, rank, b % b_loc, pg // kvr] for b in range(SHARD_BATCH)],
                    np.int32)
    full = lambda v: np.full(SHARD_BATCH, v, np.int32)  # noqa: E731
    return {"tokens": np.asarray(tokens, np.int32), "block_table": bt,
            "app_slot": slot, "app_off": full(t % SHARD_PAGE), "app_rank": full(rank),
            "lengths": full(t)}


def shard_params(cfg, seed, mesh):
    """This rank's shards of the seed's full-width f32 params (the full tree
    is made on the card, cut, and freed)."""
    from repro_torch.bridge import shard_to_torch
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda").manual_seed(seed)
    full = T.init_params(cfg, generator=gen, device="cuda")
    out = shard_to_torch(full, T.param_pspecs(full, cfg, model_size=mesh.shape["model"]),
                         mesh, device="cuda")
    del full
    torch.cuda.empty_cache()
    return out


def serve_sharded(cfg, mesh, params, prompts, n_steps, *, fed=None, on_step=None,
                  cross=None):
    """Drive ``make_serve_step`` for ``n_steps`` steps on this rank: row b
    is fed its prompt, then its own argmax (or ``fed[t]``, the global token
    stream of an earlier run).  ``on_step(t, tokens, logits)`` sees every
    step's local output; ``cross``: per segment, the global cross K/V of
    its ``xattn``/``dec`` layers.  Returns the fed global tokens (steps, B),
    the rank's final caches and the wall ms of each step (synchronised)."""
    from repro_torch.launch import serve_step as SS
    from repro_torch.launch.mesh import local_block
    shape, plan, bt = shard_geometry(cfg, mesh, n_steps)
    fn, plan, _ = SS.make_serve_step(cfg, shape, mesh, plan=plan,
                                     compute_dtype=torch.float32)
    structs, cspecs, _, sspecs, _ = SS.decode_struct(cfg, shape, mesh, plan,
                                                     dtype=torch.float32)
    caches = [{k: torch.zeros(local_block(v, cs[k], mesh).shape, dtype=v.dtype,
                              device="cuda") for k, v in c.items()}
              for c, cs in zip(structs, cspecs)]
    for c, cs, x in zip(caches, cspecs, cross or []):
        for k in x:
            c[k].copy_(local_block(x[k], cs[k], mesh))
    kvr = SS.axis_sizes(mesh, plan.kv_axes)
    d = mesh.index("data")
    b_loc = SHARD_BATCH // mesh.shape["data"]
    prev = np.zeros(SHARD_BATCH, np.int32)
    tokens_fed, walls = [], []
    for t in range(n_steps):
        tok = np.array([p[t] if t < len(p) else prev[b] for b, p in enumerate(prompts)],
                       np.int32)
        if fed is not None:
            tok = fed[t]
        tokens_fed.append(tok)
        step = {k: torch.from_numpy(np.ascontiguousarray(local_block(v, sspecs[k], mesh)))
                .to("cuda") for k, v in shard_step(bt, t, tok, kvr).items()}
        t0 = time.perf_counter()
        toks, caches, logits = fn(params, caches, step, with_logits=True)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        out = toks.cpu().numpy()
        prev = prev.copy()
        prev[d * b_loc:(d + 1) * b_loc] = out
        if on_step is not None:
            on_step(t, out, logits)
    return np.stack(tokens_fed), caches, walls


def partial_case(shape, kvr, dtype, pool, seed=21, timed=False):
    """(a): one decode batch's pages split over kvr ranks, ``shape`` = (b,
    hq, hkv, d, max_len, n_pages); each rank's partials from the kernel
    against its plain version, and combined over the ranks against one
    ``paged_attention`` call on the unsplit table (float pools) or against
    the plain partials combined (int8 pools, scales in q's dtype); a repeat
    bit-identical.  ``timed``: returns rank 0's timings and bound."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.attention import combine_partials
    b, hq, hkv, d, max_len, n_pages = shape
    q, kp, vp, btt, lt = paged_inputs(b, hq, hkv, d, SHARD_PAGE, max_len, dtype, dtype,
                                      seed, n_pages=n_pages)
    kw = {}
    if pool == "int8":
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        kp = torch.randint(-127, 128, kp.shape, device="cuda", generator=g, dtype=torch.int8)
        vp = torch.randint(-127, 128, vp.shape, device="cuda", generator=g, dtype=torch.int8)
        kw = {n: (torch.rand(kp.shape[:-1], device="cuda", generator=g) * 0.03 + 1e-3)
              .to(dtype) for n in ("k_scale", "v_scale")}
    bt = btt.cpu().numpy()
    tables = [torch.from_numpy(np.ascontiguousarray(bt[:, r::kvr])).to("cuda")
              for r in range(kvr)]
    call = lambda fn, r: fn(q, kp, vp, tables[r], lt, kvr=kvr, rank=r, **kw)  # noqa: E731
    parts = [call(pa.paged_attention_partials, r) for r in range(kvr)]
    again = [call(pa.paged_attention_partials, r) for r in range(kvr)]
    plain = [call(pa.paged_attention_partials_plain, r) for r in range(kvr)]
    name = (f"partials B{b} Hq{hq} Hkv{hkv} D{d} len<={max_len} P{bt.shape[1]} kvr {kvr} "
            f"q {str(dtype)[6:]} pool {pool}")
    for a, b_, c in zip(parts, again, plain):
        assert_repeatable(name, a, b_)
        for got, want in zip(a, c):
            assert_close(name, got, want, dtype)
    got = combine_partials(tuple(torch.stack(x) for x in zip(*parts)), dtype)
    if pool == "int8":
        want = combine_partials(tuple(torch.stack(x) for x in zip(*plain)), dtype)
        tol = TOL[dtype]
    else:
        want = pa.paged_attention(q, kp, vp, btt, lt)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
    err = max_err(got, want)
    if err > tol or not torch.isfinite(got).all():
        fail(f"{name}: combined partials {err:.3e} from the reference (tol {tol})")
    if not timed:
        log(f"  (a) {name}: {pa.plan_for(q, kp, tables[0])[1]} splits, combined err "
            f"{err:.3e}")
        return None
    # one rank's call: its live tokens, bytes and operations
    lengths, r = lt.cpu().numpy(), 0
    local = bt[:, r::kvr]
    live = sum(max(0, min(SHARD_PAGE, int(lengths[i]) - (j * kvr + r) * SHARD_PAGE))
               for i in range(local.shape[0]) for j in range(local.shape[1])
               if local[i, j] >= 0)
    kv_el, q_el = kp.element_size(), q.element_size()
    n_bytes = (2 * live * hkv * d * kv_el + b * hq * d * q_el + local.nbytes
               + lengths.nbytes + 4 * b * hq * (d + 2)
               + (2 * live * hkv * q_el if pool == "int8" else 0))
    n_ops = 4 * live * hq * d
    one = tables[r]
    kernel_fn = lambda: pa.paged_attention_partials(q, kp, vp, one, lt, kvr=kvr, rank=r, **kw)  # noqa: E731
    plain_fn = lambda: pa.paged_attention_partials_plain(q, kp, vp, one, lt, kvr=kvr, rank=r,  # noqa: E731
                                                         **kw)
    times = timings(kernel_fn, plain_fn, None, flush=l2_flush())
    bms, by = bound_ms(n_bytes, n_ops, torch.float32)      # the products run in f32
    log(f"  (a) {name}: {pa.plan_for(q, kp, one)[1]} splits, combined err {err:.3e}; "
        f"rank 0: {times_text(times)}  bound {bms:.4f} ms ({by}; "
        f"{100 * bms / times['device_ms']:.1f}% of the device time)")
    return dict(max_abs_err=err, bound_ms=bms, bound_by=by, **times)


def _gloo_init(rank, port, world, init=None):
    """A spawned rank's process group: gloo over ``world`` ranks on the
    shared card (met at ``port``, or at the ``init`` method), TF32 off, and
    counts of the kernels' plain versions run on CUDA tensors (returned,
    {kernel: calls})."""
    import datetime
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ssd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init or f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SHARD_SECONDS))
    plain_calls = {"paged_partials": 0, "flash": 0, "ssd": 0}
    for key, mod, fn in (("paged_partials", pa, "paged_attention_partials_plain"),
                         ("flash", fa, "flash_attention_plain"), ("ssd", ssd, "ssd_scan_plain")):
        def counted(x, *a, _fn=getattr(mod, fn), _key=key, **kw):
            plain_calls[_key] += int(x.is_cuda)
            return _fn(x, *a, **kw)
        setattr(mod, fn, counted)
    return plain_calls


def _gloo_rank(rank, port):
    """A spawned rank's setup: gloo over ``SHARD_MESH`` on the shared card,
    its mesh (``Mesh.stats`` counts each transport and the host wall inside
    it), and counts of the kernels' plain versions run on CUDA tensors.
    Returns (mesh, {kernel: plain calls})."""
    from repro_torch.launch import mesh as mesh_lib
    plain_calls = _gloo_init(rank, port, SHARD_MESH[0] * SHARD_MESH[1])
    return mesh_lib.make_local_mesh(*SHARD_MESH), plain_calls


def _shard_rank(rank, port, name, n_layers, seed, prompts, fed, ref_logits, out_dir):
    """One of (c)'s gloo ranks on the shared card: the sharded serve step on
    (b)'s token stream, every step's logits held against (b)'s, then one
    migration step checked against the moved payloads."""
    import torch.distributed as dist
    from repro_torch.configs import ARCHS, replace
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve_step as SS
    mesh, plain_calls = _gloo_rank(rank, port)
    cfg = replace(ARCHS[name], n_layers=n_layers)
    params = shard_params(cfg, seed, mesh)
    d = mesh.index("data")
    b_loc = SHARD_BATCH // mesh.shape["data"]
    worst, flips, per_step_coll = 0.0, 0, []
    pa.paged_attention_partials.launches = 0

    def check(t, toks, logits):
        nonlocal worst, flips
        per_step_coll.append(mesh.stats_total()[1])
        # the real vocab: the padded tail is -1e30 in both
        ref = ref_logits[t, d * b_loc:(d + 1) * b_loc, :cfg.vocab]
        logits = logits[:, :cfg.vocab]
        scale = float(ref.abs().max())
        worst = max(worst, max_err(logits, ref) / scale)
        top2 = ref.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > SHARD_TOL * scale
        flips += int(((logits.argmax(-1) != ref.argmax(-1)) & sure).sum())

    _, caches, walls = serve_sharded(cfg, mesh, params, prompts, len(fed), fed=fed,
                                     on_step=check)
    launches = pa.paged_attention_partials.launches
    calls_per_step = mesh.stats_total()[0] / len(fed)
    coll = np.diff([0.0] + per_step_coll)
    # one migration step on the first paged segment: payloads go one hop
    # along the model ring; the destination slots must hold exactly what
    # the previous rank sent
    seg = next(i for i, c in enumerate(caches) if "pool_k" in c)
    slots = caches[seg]["pool_k"].shape[3]
    g = np.random.default_rng(100 + rank)
    src = torch.from_numpy(g.permutation(slots)[:4].astype(np.int32)).to("cuda")[None, None]
    dst = torch.from_numpy(g.permutation(slots)[:4].astype(np.int32)).to("cuda")[None, None]
    migrate = SS.make_migrate_step(mesh, SS.DecodePlan(("data",), ("model",),
                                                       page=SHARD_PAGE))
    kvr, my = mesh.shape["model"], mesh.index("model")
    moved = {}
    for key in ("pool_k", "pool_v"):
        payload = caches[seg][key][:, 0, 0][:, src[0, 0].long()]
        moved[key] = mesh.all_gather(payload[None], "model", dim=0)[(my - 1) % kvr]
    migrate(caches[seg]["pool_k"], caches[seg]["pool_v"], src, dst)
    migrated = all(torch.equal(caches[seg][k][:, 0, 0][:, dst[0, 0].long()], moved[k])
                   for k in moved)
    res = dict(rank=rank, worst=worst, flips=flips, launches=launches,
               plain_cuda_calls=plain_calls["paged_partials"], migrated=migrated,
               step_ms=float(np.median(walls[1:])), coll_ms=float(np.median(coll[1:])),
               coll_calls=calls_per_step,
               backend=mesh.backend, staged=sorted(mesh_lib.HOST_STAGED),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def no_decode_positions():
    """``models.decode`` without the sinusoidal position it adds to each
    decode token of the audio arch: the reference's serve step adds none."""
    from repro_torch.models import decode as D
    real = D.sinusoidal_at
    D.sinusoidal_at = lambda pos, d: 0 * real(pos, d)  # exact zeros
    try:
        yield
    finally:
        D.sinusoidal_at = real


def against_decode(cfg, params, fed, steps_logits, toks, cross=None):
    """Single-device ``models.decode`` on the token stream ``fed`` (steps,
    B), its cross-attention caches filled from ``cross`` (``cross_kv``'s,
    per segment), without the audio arch's decode positions
    (``no_decode_positions``): (the worst logit error relative to the
    largest, the argmax mismatches) of a serve step run's ``steps_logits``
    and ``toks``."""
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    ctx = T.ParallelCtx(remat=False, compute_dtype=torch.float32)
    n_steps = len(fed)
    n_pages = -(-n_steps // SHARD_PAGE)
    bt = torch.arange(SHARD_BATCH * n_pages, dtype=torch.int32,
                      device="cuda").reshape(SHARD_BATCH, n_pages)
    worst, mism = 0.0, 0
    with off_path(), no_decode_positions():
        n_cross = next((x["cross_k"].shape[2] for x in cross or [] if x), 0)
        caches = D.init_caches(cfg, SHARD_BATCH, pool_slots=SHARD_BATCH * n_pages,
                               page=SHARD_PAGE, n_cross=n_cross, device="cuda")
        for info, c in zip(D.layer_infos(cfg), caches["layers"]):
            if info.uses_cross:
                for key in ("cross_k", "cross_v"):
                    c[key].copy_(cross[info.seg][key][info.idx])
        for t in range(n_steps):
            lg, caches = D.decode_step(params, caches, torch.from_numpy(fed[t]).to("cuda"),
                                       cfg, ctx, bt, bt[:, t // SHARD_PAGE],
                                       torch.full((SHARD_BATCH,), t % SHARD_PAGE))
            real = lg[:, :cfg.vocab]          # the padded tail is -1e30 in both
            worst = max(worst, max_err(steps_logits[t, :, :cfg.vocab], real)
                        / float(real.abs().max()))
            mism += int((lg.argmax(-1).cpu().numpy() != toks[t]).sum())
    return worst, mism


def run_ranks(fn, args, name, world=SHARD_MESH[0] * SHARD_MESH[1]):
    """``fn(rank, port, *args, out_dir)`` on ``world`` ranks (spawned;
    killed past ``SHARD_SECONDS``): the JSON each wrote to
    ``out_dir/rank<r>.json``."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out_dir:
        procs = mp.start_processes(fn, args=(_free_port(),) + tuple(args) + (out_dir,),
                                   nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + SHARD_SECONDS
        try:
            while not procs.join(timeout=max(deadline - time.monotonic(), 1.0)):
                if time.monotonic() > deadline:
                    fail(f"{name}: the {world} ranks outlasted {SHARD_SECONDS} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                for r in range(world)]


def shard_arch(name, n_layers, seed):
    """(b) then (c) for one arch."""
    import torch.distributed as dist
    from repro_torch.configs import ARCHS, replace
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as T
    cfg = replace(ARCHS[name], n_layers=n_layers)
    prompts = shard_prompts(cfg, seed)
    n_steps = max(len(p) for p in prompts) + SHARD_NEW
    # (b) one rank, a 1x1 mesh over NCCL
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    mesh = make_local_mesh(1, 1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, generator=gen, device="cuda")
    steps_logits = torch.empty((n_steps, SHARD_BATCH, cfg.padded_vocab), device="cuda")
    toks_b = []

    def keep(t, toks, logits):
        steps_logits[t] = logits
        toks_b.append(toks)
    fed, _, walls = serve_sharded(cfg, mesh, params, prompts, n_steps, on_step=keep)
    dist.destroy_process_group()
    # a step reads every weight once, but of an untied input embedding only
    # its batch's rows
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    if not cfg.tie_embeddings:
        w_bytes -= params["embed"].numel() * params["embed"].element_size()
    # ... held against single-device models.decode on the same token stream
    worst, mism = against_decode(cfg, params, fed, steps_logits, toks_b)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (b) {name} ({n_layers} layers) one rank: {n_steps} steps, "
        f"{float(np.median(walls[1:])):.3f} ms per step (median; the weights' byte "
        f"bound {1e3 * w_bytes / HBM_BYTES_PER_S:.3f} ms), logits within "
        f"{worst:.3e} of the largest of models.decode's, {mism} tokens differ")
    if worst > SHARD_TOL or mism:
        fail(f"{name}: the one-rank serve step differs from models.decode "
             f"({worst:.3e}, {mism} tokens)")
    # (c) four ranks sharing the card over gloo, fed (b)'s tokens
    res = run_ranks(_shard_rank, (name, n_layers, seed, prompts, fed, steps_logits), name)
    del steps_logits
    torch.cuda.empty_cache()
    pa.paged_attention_partials.launches += sum(r["launches"] for r in res)
    PLAIN_CUDA_CALLS["paged_partials"] += sum(r["plain_cuda_calls"] for r in res)
    worst = max(r["worst"] for r in res)
    flips = sum(r["flips"] for r in res)
    log(f"  (c) {name} four ranks (2x2, gloo, one card): per-step wall "
        f"{[round(r['step_ms'], 3) for r in res]} ms (median), host wall inside "
        f"{res[0]['coll_calls']:.0f} collective calls (waits for their inputs' "
        f"kernels included) {[round(r['coll_ms'], 3) for r in res]} ms per step; logits "
        f"within {worst:.3e} of (b)'s largest; {flips} argmax flips past the top-2 "
        f"gap; migration bit-equal {[r['migrated'] for r in res]}; partial launches "
        f"{[r['launches'] for r in res]}; staged through the host on "
        f"{res[0]['backend']}: {res[0]['staged']}; peak "
        f"{[round(r['peak_gb'], 2) for r in res]} GB")
    if worst > SHARD_TOL or flips or not all(r["migrated"] for r in res):
        fail(f"{name}: the four-rank serve step disagrees with one rank's")


def phase_sharded():
    from repro_torch.configs import ARCHS
    log("phase 12: the sharded serve step (launch/serve_step.py): the partial entry "
        "of the paged kernel, then full-width "
        + " and ".join(f"{n} ({k} of {ARCHS[n].n_layers} layers)" for n, k, _ in SHARD_ARCHS)
        + " on one rank (NCCL) and on four ranks sharing the card (gloo), f32")
    with off_path():
        rec = None
        for shape, batches, kvrs in PARTIAL_SHAPES:
            for b in batches:
                for kvr in kvrs:
                    for dtype, pool in ((torch.float32, "float32"),
                                        (torch.bfloat16, "bfloat16"),
                                        (torch.float32, "int8"), (torch.bfloat16, "int8")):
                        timed = rec is None and kvr == 2 and pool == "float32"
                        r = partial_case((b,) + shape, kvr, dtype, pool, timed=timed)
                        rec = rec or r
    for name, n_layers, seed in SHARD_ARCHS:
        shard_arch(name, n_layers, seed)
    return rec



# --------------------------------------------------------------------------
# Phase 13: the sharded prefill cell and the serve step of the other kinds
# --------------------------------------------------------------------------

# Full width, f32, depth cut so that the whole run stays near half of its
# limit: hymba-1.5b at 4 of 32 layers (3 global + 1 sliding-window: SSD
# heads, paged partials, rings), deepseek-moe-16b at 2 of 28 (1 dense + 1
# MoE layer; EP over 64 experts), whisper-large-v3 at 2 + 2 of 32 + 32
# (cross K/V over 1536 frames)
KINDS_ARCHS = (("hymba-1.5b", dict(n_layers=4), 41),
               ("deepseek-moe-16b", dict(n_layers=2), 42),
               ("whisper-large-v3", dict(n_layers=2, encoder_layers=2), 43))
KINDS_PREFILL = (2, 509)     # the prefill cell's batch (one row a data rank)
                             # and prompt (S % 2 != 0 under seq_parallel)
KINDS_PROMPTS = (16, 32)     # the serve step's prompts, fed one per step,
KINDS_NEW = 16               # then this many generated
KINDS_TOL = 1e-5             # of the largest logit (real vocab)


def kinds_inputs(cfg, seed):
    """The prefill cell's global tokens and frontend, the serve step's
    prompts and frontend, all seeded."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    b, s = KINDS_PREFILL
    tokens = torch.randint(2, cfg.vocab, (b, s), generator=g, device="cuda")
    fe = fe_serve = None
    if cfg.n_frontend_tokens:
        fe = torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=g,
                         device="cuda")
        fe_serve = torch.randn((SHARD_BATCH, cfg.n_frontend_tokens, cfg.d_model),
                               generator=g, device="cuda")
    rng = np.random.default_rng(seed)
    lens = rng.integers(KINDS_PROMPTS[0], KINDS_PROMPTS[1] + 1, size=SHARD_BATCH)
    prompts = [rng.integers(2, cfg.vocab, size=int(n)) for n in lens]
    return tokens, fe, prompts, fe_serve


def cross_kv(cfg, params, frontend):
    """Per segment, the serve step's global cross K/V (n, B, N, kv, hd): the
    frontend, or whisper's encoder output over it, projected by each cross
    layer's ``wk``/``wv``."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import matmul
    if frontend is None:
        return None
    ctx = T.ParallelCtx(remat=False, compute_dtype=torch.float32)
    enc = T.encode(params, frontend, cfg, ctx) if cfg.family == "audio" else frontend
    b, n = enc.shape[:2]
    out = []
    for seg, p in zip(T.segments(cfg), params["segments"]):
        c = {}
        if seg.kind in ("xattn", "dec"):
            for key, w in (("cross_k", "wk"), ("cross_v", "wv")):
                c[key] = torch.stack([
                    matmul(enc, p["xattn"][w][i]).reshape(b, n, cfg.n_kv_heads, -1)
                    for i in range(seg.count)])
        out.append(c)
    return out


def prefill_cell(cfg, mesh):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import build_prefill_cell
    b, s = KINDS_PREFILL
    shape = ShapeConfig("chip_smoke", seq_len=s, global_batch=b, kind="prefill")
    return build_prefill_cell(cfg, shape, mesh, compute_dtype=torch.float32)


def wall_ms(fn):
    """Synchronised host wall of one call of ``fn``, ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def rel_err(got, want, vocab):
    """Largest error over the real vocab, relative to the largest logit."""
    want = want[..., :vocab]
    return max_err(got[..., :vocab], want) / float(want.abs().max())


@contextlib.contextmanager
def shapes_seen():
    """Note the shapes of every call the model makes of the three kernels'
    wrappers, at their call sites (``kernels.ops`` for flash, paged and
    SSD, the serve step for the partial entry): yields {kernel: set of
    keys}, the keys ``hold_seen`` takes."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_step as SS
    seen = {"flash": set(), "ssd": set(), "paged_partials": set(), "paged": set()}
    flash, ssd, partials, paged = ops._flash, ops._ssd, SS.paged_attention_partials, ops._paged
    name = lambda t: str(t.dtype)[6:]  # noqa: E731

    def flash_(q, k, v, *, causal=True, window=0):
        seen["flash"].add((q.shape[0], k.shape[0], q.shape[2], q.shape[1], k.shape[1],
                           causal, window, name(q)))
        return flash(q, k, v, causal=causal, window=window)

    def ssd_(x, dt, a, bm, cm, chunk):
        seen["ssd"].add(tuple(x.shape) + tuple(bm.shape[2:]) + (chunk, name(x)))
        return ssd(x, dt, a, bm, cm, chunk)

    def partials_(q, kp, vp, bt, lengths, **kw):
        (b, hq, d), hkv = q.shape, kp.shape[2]
        seen["paged_partials"].add((b, hq, hkv, d, bt.shape[1], kw["kvr"], name(q), name(kp)))
        return partials(q, kp, vp, bt, lengths, **kw)

    def paged_(q, kp, vp, bt, lengths):
        (b, hq, d), (page, hkv) = q.shape, kp.shape[1:3]
        seen["paged"].add((b, hq, hkv, d, page, bt.shape[1], name(q), name(kp)))
        return paged(q, kp, vp, bt, lengths)

    ops._flash, ops._ssd, SS.paged_attention_partials, ops._paged = \
        flash_, ssd_, partials_, paged_
    try:
        yield seen
    finally:
        ops._flash, ops._ssd, SS.paged_attention_partials, ops._paged = \
            flash, ssd, partials, paged


def hold_seen(seen, phase, need):
    """Every shape ``shapes_seen`` noted on a phase's path, on fresh seeded
    inputs: the flash, paged and SSD kernels against their plain versions,
    the partial entry's partials against its plain version and combined
    over the ranks against one unsplit call (``partial_case``).  Fails if
    a kernel in ``need`` was seen at no shape."""
    for key in need:
        if not seen[key]:
            fail(f"phase {phase}: no {key} call was seen at the model's call sites")
    for i, (hq, hkv, d, sq, sk, causal, window, dt) in enumerate(sorted(seen["flash"])):
        flash_case(f"flash Hq{hq} Hkv{hkv} D{d} Sq{sq} Sk{sk} "
                   f"{'causal' if causal else 'non-causal'} window{window} {dt}",
                   hq, hkv, d, sq, causal, window, getattr(torch, dt), seed=60 + i, sk=sk,
                   timed=False)
    for i, (b, s, h, p, g, n, chunk, dt) in enumerate(sorted(seen["ssd"])):
        ssd_case(f"ssd B{b} S{s} H{h} P{p} G{g} N{n} chunk{chunk} {dt}", b, s, h, p, g, n,
                 chunk, getattr(torch, dt), seed=80 + i, timed=False)
    for i, (b, hq, hkv, d, page, n_pages, qd, pool) in enumerate(sorted(seen["paged"])):
        paged_case(f"paged B{b} Hq{hq} Hkv{hkv} D{d} page{page} pages{n_pages} {qd} q "
                   f"{pool} pool", b, hq, hkv, d, page, n_pages * page, getattr(torch, qd),
                   getattr(torch, pool), seed=90 + i, timed=False, n_pages=n_pages)
    for b, hq, hkv, d, p_loc, kvr, qd, pool in sorted(seen["paged_partials"]):
        if pool not in ("int8", qd):
            fail(f"phase {phase}: no partial case builds a {pool} pool under {qd} q")
        n_pages = p_loc * kvr
        partial_case((b, hq, hkv, d, n_pages * SHARD_PAGE, n_pages), kvr,
                     getattr(torch, qd), pool)


def _kinds_rank(rank, port, name, over, seed, tokens, fe, ref_prefill, prompts, fed,
                ref_logits, cross, out_dir):
    """One of (c)'s gloo ranks: the prefill cell on its rows held against
    (b)'s logits, then the serve step on (b)'s token stream, every step's
    logits held against (b)'s; then one profiled prefill (off the counts).
    Also returns the shapes the rank gave the kernels (``shapes_seen``)."""
    import torch.distributed as dist
    from repro_torch.configs import ARCHS, replace
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.mesh import local_block
    mesh, plain_calls = _gloo_rank(rank, port)
    ms_calls = lambda: mesh.stats_total()[::-1]  # noqa: E731
    with shapes_seen() as seen:
        cfg = replace(ARCHS[name], **over)
        params = shard_params(cfg, seed, mesh)
        wrappers = (fa.flash_attention, ssd.ssd_scan, pa.paged_attention_partials)
        for w in wrappers:
            w.launches = 0
        d = mesh.index("data")
        rows = lambda x, n: x[d * n:(d + 1) * n]  # noqa: E731
        toks_l = local_block(tokens, ("data", None), mesh)
        fe_l = None if fe is None else local_block(fe, ("data", None, None), mesh)
        cell = prefill_cell(cfg, mesh)
        dist.barrier()
        calls0 = ms_calls()[1]
        got = cell.fn(params, toks_l, fe_l)
        prefill_calls = ms_calls()[1] - calls0
        prefill_err = rel_err(got, rows(ref_prefill, KINDS_PREFILL[0] // SHARD_MESH[0]),
                              cfg.vocab)
        with off_path():           # a second call, past the first one's warm-up
            dist.barrier()
            prefill_ms = wall_ms(lambda: cell.fn(params, toks_l, fe_l))
        b_loc = SHARD_BATCH // SHARD_MESH[0]
        worst, flips, per_step = 0.0, 0, []

        def check(t, toks, logits):
            nonlocal worst, flips
            per_step.append(ms_calls())
            ref = rows(ref_logits[t], b_loc)[:, :cfg.vocab]
            worst = max(worst, rel_err(logits, ref, cfg.vocab))
            top2 = ref.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > KINDS_TOL * float(ref.abs().max())
            flips += int(((logits[:, :cfg.vocab].argmax(-1) != ref.argmax(-1)) & sure).sum())

        dist.barrier()
        base = ms_calls()
        _, _, walls = serve_sharded(cfg, mesh, params, prompts, len(fed), fed=fed,
                                    on_step=check, cross=cross)
        launches = [w.launches for w in wrappers]
        coll = np.diff(np.array([base] + per_step), axis=0)   # per step: (ms, calls)
        dist.barrier()
        # device busy of one prefill, profiled (its launches are not counted)
        with off_path():
            _, busy, _, _ = profile_step(lambda: cell.fn(params, toks_l, fe_l))
        res = dict(rank=rank, prefill_err=prefill_err, prefill_ms=prefill_ms,
                   prefill_calls=prefill_calls, prefill_busy_ms=busy, worst=worst,
                   flips=flips, launches=launches, plain_cuda_calls=plain_calls,
                   step_ms=float(np.median(walls[1:])), coll_ms=float(np.median(coll[1:, 0])),
                   coll_calls=float(np.median(coll[1:, 1])),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   shapes={k: sorted(v) for k, v in seen.items()})
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def kinds_arch(name, over, seed, seen):
    """(b) one rank (1x1, NCCL): the prefill cell against the unsharded
    ``prefill_logits``, the serve step against ``models.decode``; (c) four
    ranks (2x2, gloo, one card) against (b).  The shapes (c)'s ranks gave
    the kernels join ``seen``."""
    import torch.distributed as dist
    from repro_torch.configs import ARCHS, replace
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ops import flash_attention_op
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as T
    cfg = replace(ARCHS[name], **over)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    mesh = make_local_mesh(1, 1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, generator=gen, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    tokens, fe, prompts, fe_serve = kinds_inputs(cfg, seed)
    cell = prefill_cell(cfg, mesh)
    got = cell.fn(params, tokens, fe)
    with off_path():
        ctx = T.ParallelCtx(remat=False, compute_dtype=torch.float32)
        plain = T.prefill_logits(params, tokens, cfg, ctx, frontend=fe,
                                 attention=flash_attention_op)
        prefill_ms = wall_ms(lambda: cell.fn(params, tokens, fe))
        _, busy, n_kernels, _ = profile_step(lambda: cell.fn(params, tokens, fe))
        # (c)'s reference: the cell on each data rank's rows (an MoE
        # dispatch takes its capacity from the rows of its call)
        n = KINDS_PREFILL[0] // SHARD_MESH[0]
        ref_prefill = torch.cat([
            cell.fn(params, tokens[i:i + n], None if fe is None else fe[i:i + n])
            for i in range(0, KINDS_PREFILL[0], n)])
        cross = cross_kv(cfg, params, fe_serve)
    err1 = rel_err(got, plain, cfg.vocab)
    n_steps = max(len(p) for p in prompts) + KINDS_NEW
    steps_logits = torch.empty((n_steps, SHARD_BATCH, cfg.padded_vocab), device="cuda")
    toks_b = []

    def keep(t, toks, logits):
        steps_logits[t] = logits
        toks_b.append(toks)
    fed, _, walls = serve_sharded(cfg, mesh, params, prompts, n_steps, on_step=keep,
                                  cross=cross)
    dist.destroy_process_group()
    dec = against_decode(cfg, params, fed, steps_logits, toks_b, cross)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (b) {name} ({over}, {n_params / 1e9:.3f} B params) one rank: prefill cell "
        f"B {KINDS_PREFILL[0]} S {KINDS_PREFILL[1]} {prefill_ms:.3f} ms (a second call; device busy "
        f"{busy:.3f} ms, {n_kernels} kernels, profiled), within {err1:.3e} of the "
        f"unsharded prefill_logits' largest; serve step {n_steps} steps, "
        f"{float(np.median(walls[1:])):.3f} ms per step (median), within {dec[0]:.3e} "
        f"of models.decode's largest, {dec[1]} tokens differ")
    if err1 > KINDS_TOL or dec[0] > KINDS_TOL or dec[1]:
        fail(f"{name}: the one-rank prefill cell or serve step disagrees "
             f"({err1:.3e}, {dec})")
    res = run_ranks(_kinds_rank, (name, over, seed, tokens, fe, ref_prefill, prompts, fed,
                                  steps_logits, cross), name)
    del steps_logits, cross, ref_prefill
    torch.cuda.empty_cache()
    for w, i in ((fa.flash_attention, 0), (ssd.ssd_scan, 1), (pa.paged_attention_partials, 2)):
        w.launches += sum(r["launches"][i] for r in res)
    for key in ("flash", "ssd", "paged_partials"):
        PLAIN_CUDA_CALLS[key] += sum(r["plain_cuda_calls"][key] for r in res)
        seen[key].update(tuple(k) for r in res for k in r["shapes"][key])
    pre = max(r["prefill_err"] for r in res)
    worst = max(r["worst"] for r in res)
    flips = sum(r["flips"] for r in res)
    log(f"  (c) {name} four ranks (2x2, gloo, one card): prefill cell (a second call) "
        f"{[round(r['prefill_ms'], 3) for r in res]} ms, {res[0]['prefill_calls']} "
        f"collective calls, device busy {[round(r['prefill_busy_ms'], 3) for r in res]} ms "
        f"(profiled), within {pre:.3e} of the largest of (b)'s on the data rank's rows; "
        f"serve step "
        f"{[round(r['step_ms'], 3) for r in res]} ms per step (median), "
        f"{res[0]['coll_calls']:.0f} collective calls per step, host wall inside them "
        f"{[round(r['coll_ms'], 3) for r in res]} ms; logits within {worst:.3e} of (b)'s "
        f"largest, {flips} argmax flips past the top-2 gap; launches (flash, ssd, "
        f"partials) {[r['launches'] for r in res]}; peak "
        f"{[round(r['peak_gb'], 2) for r in res]} GB")
    if pre > KINDS_TOL or worst > KINDS_TOL or flips:
        fail(f"{name}: four ranks disagree with one ({pre:.3e}, {worst:.3e}, {flips})")


def phase_kinds():
    from repro_torch.configs import ARCHS
    log("phase 13: the sharded prefill cell and serve step of the other kinds: "
        + ", ".join(f"{n} ({over['n_layers']} of {ARCHS[n].n_layers} layers)"
                    for n, over, _ in KINDS_ARCHS)
        + " (whisper's encoder as deep as its decoder), f32, on one rank (NCCL) and "
        "four sharing the card (gloo); then every shape the path gave a kernel against "
        "its plain version")
    with shapes_seen() as seen:
        for name, over, seed in KINDS_ARCHS:
            kinds_arch(name, over, seed, seen)
    with off_path():
        hold_seen(seen, 13, ("flash", "ssd", "paged_partials"))


# --------------------------------------------------------------------------
# Phase 14: sharded training
# --------------------------------------------------------------------------

# Full-width mamba2-2.7b at 4 of 64 layers (its SSD heads on the kernel
# under autograd, 40 a rank at model 2), f32 with TF32 off for the checks:
# SHTRAIN_STEPS steps of SHTRAIN_MICRO microbatches of SHTRAIN_BATCH / 2
# rows of SHTRAIN_SEQ tokens, ZeRO-1, remat with the collectives saved
SHTRAIN_ARCH = ("mamba2-2.7b", 4, 14)       # name, layers, seed
SHTRAIN_SEQ = 1024
SHTRAIN_BATCH, SHTRAIN_MICRO = 4, 2
SHTRAIN_STEPS = 3
SHTRAIN_MESH = (2, 2)                        # (b): data x model ranks on the card
SHTRAIN_WITNESS = ((2, 1), (1, 2))           # (e): data only, model only
SHTRAIN_REL = 1e-5                           # loss and grad norm, relative
SHTRAIN_MOMENTS = TOL[torch.float32]         # AdamW's moments (the first after the
                                             # first and the last step, the second's
                                             # root after the last), of each leaf's
                                             # largest entry: f32's limit
SHTRAIN_ABS = 1e-4                           # params, absolute
# AdamW's step is g / (|g| + 1e-8) at the first update, so a gradient
# element near 1e-8 moves by up to ~lr on a rounding gap of its own size:
# at phase 11's 3e-4, (b)'s params were 1.597e-04 from (a)'s after one step
# while their losses and grad norms agreed to 3.2e-07 (PERF.md, phase 14).
# The checks run at a tenth of that rate.  There a step moves an entry by
# at most ~lr, so the parameter limit fails only where most of an entry's
# steps were reversed; the moments hold the gradients of every step
SHTRAIN_LR = 3e-5
# (c) GPipe: full-width granite-3-8b at 2 of 40 layers (1 a stage), bf16,
# PP_MICRO microbatches of one row of PP_SEQ tokens
PP_ARCH = ("granite-3-8b", 2, 15)
PP_MICRO, PP_SEQ = 4, 1024
PP_REL = 2e-2


def shtrain_config(dtype):
    from repro_torch import optim
    from repro_torch.train import TrainConfig
    return TrainConfig(microbatches=SHTRAIN_MICRO, zero1=True, compute_dtype=dtype,
                       adamw=optim.AdamWConfig(lr=SHTRAIN_LR, warmup_steps=0,
                                               total_steps=60))


def shtrain_data(cfg, seed):
    """(steps, n_micro, mb, S) tokens and labels, numpy-seeded; labels of -1
    in part of the microbatches' first row (data rank 0's at 2x2)."""
    rng = np.random.default_rng(seed)
    shape = (SHTRAIN_STEPS, SHTRAIN_MICRO, SHTRAIN_BATCH // SHTRAIN_MICRO, SHTRAIN_SEQ)
    toks = rng.integers(0, cfg.vocab, shape)
    labels = rng.integers(0, cfg.vocab, shape)
    labels[:, :, 0, 100:400] = -1
    return toks, labels


def sharded_state(cfg, seed, mesh, ctx, tcfg):
    """The seed's f32 params and a fresh AdamW state: whole without a mesh,
    else this rank's shards and ZeRO-1 blocks (the full tree is made on the
    card, cut and freed).  Returns (params, state, (param placements,
    moment placements), batch placement)."""
    from repro_torch import bridge, optim
    from repro_torch.models import transformer as T
    from repro_torch.train import make_shardings
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, generator=gen, device="cuda")
    if mesh is None:
        return params, optim.init(params), (None, None), (None, None, None)
    (pspecs, ospecs, batch, _), _ = make_shardings(cfg, ctx, tcfg, params)
    params = bridge.shard_to_torch(params, pspecs, mesh, device="cuda")
    torch.cuda.empty_cache()
    return params, zero_state(cfg, ospecs.mu, mesh), (pspecs, ospecs.mu), batch


def zero_state(cfg, moment_specs, mesh):
    """A fresh AdamW state of this rank's blocks under ``moment_specs``."""
    from repro_torch import bridge, optim
    from repro_torch.launch.mesh import local_block
    from repro_torch.models import transformer as T
    meta = T.init_params(cfg, generator=None, device="meta")
    zeros = lambda sp, a: torch.zeros(local_block(a, sp, mesh).shape, device="cuda")
    return optim.AdamWState(torch.zeros((), dtype=torch.int32, device="cuda"),
                            bridge.tree_map_specs(zeros, moment_specs, meta),
                            bridge.tree_map_specs(zeros, moment_specs, meta))


def shtrain_run(cfg, mesh, seed, data, dtype, steps=SHTRAIN_STEPS):
    """``steps`` steps of ``make_train_step`` from the seed's state on
    ``mesh`` (None: one device, the unsharded step): {losses, norms, walls
    (s), coll (per step: forward calls, backward calls, host ms inside
    them), ssd (launches), first ([params leaves, first-moment leaves] after
    the first step), last ([first-moment, second-moment leaves] after the
    last), params (after the last), specs (their placements)}."""
    from repro_torch.bridge import tree_flatten
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.mesh import local_block
    from repro_torch.models import transformer as T
    from repro_torch.train import make_train_step
    tcfg = shtrain_config(dtype)
    ctx = T.ParallelCtx(mesh=mesh, remat=True, compute_dtype=dtype,
                        save_collectives=mesh is not None)
    params, state, specs, batch = sharded_state(cfg, seed, mesh, ctx, tcfg)
    step = make_train_step(cfg, ctx, tcfg)
    out = dict(losses=[], norms=[], walls=[], coll=[], specs=specs)
    ssd0 = ssd.ssd_scan.launches
    for t in range(steps):
        toks, labels = (torch.as_tensor(local_block(a[t], batch, mesh) if mesh else a[t],
                                        device="cuda") for a in data)
        before = [mesh.stats_total(d) for d in ("forward", "backward")] if mesh else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, toks, labels)
        torch.cuda.synchronize()
        out["walls"].append(time.perf_counter() - t0)
        if t == 0:
            out["first"] = [[a.clone() for a in tree_flatten(tree)[0]]
                            for tree in (params, state.mu)]
        out["losses"].append(float(m["loss"]))
        out["norms"].append(float(m["grad_norm"]))
        if mesh:
            (fc, fms), (bc, bms) = [mesh.stats_total(d) for d in ("forward", "backward")]
            out["coll"].append((fc - before[0][0], bc - before[1][0],
                                fms - before[0][1] + bms - before[1][1]))
    out["ssd"] = ssd.ssd_scan.launches - ssd0
    out["params"] = params
    out["last"] = [tree_flatten(tree)[0] for tree in (state.mu, state.nu)]
    return out


def as_ref(run):
    """What a run is held against: its losses, norms and leaves."""
    from repro_torch.bridge import tree_flatten
    return dict(losses=run["losses"], norms=run["norms"], first=run["first"],
                last=run["last"], params=tree_flatten(run["params"])[0])


def params_gap(a, b):
    """The largest |a - b| over two param trees."""
    from repro_torch.bridge import tree_flatten
    return max(max_err(x, y) for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]))


def shtrain_gaps(a, b):
    """(the largest relative gap of the losses and grad norms of two runs,
    over ``a``'s steps)."""
    return max(abs(x - y) / abs(y) for k in ("losses", "norms")
               for x, y in zip(a[k], b[k]))


def leaf_gaps(mine, theirs, specs, mesh, names, *, scaled, root=False):
    """[(the largest |mine - theirs| of a leaf, of their square roots where
    ``root``, over the leaf's largest |theirs| where ``scaled``; its name)],
    a one-rank ``theirs`` cut to this rank's blocks under ``specs``."""
    from repro_torch.launch.mesh import local_block
    out = []
    for got, want, sp, name in zip(mine, theirs, specs, names):
        want = local_block(want, sp, mesh) if mesh else want
        if root:
            got, want = got.sqrt(), want.sqrt()
        scale = max(float(want.abs().max()), 1e-30) if scaled else 1.0
        out.append((max_err(got, want) / scale, name))
    return out


def run_gaps(run, ref, mesh=None):
    """``run`` against a one-rank ``ref`` (``as_ref``): {params1, params: the
    largest param gap after the first and the last step; moments: (the
    largest moment gap of its leaf's largest entry, where); a_log: the
    first moment's after the first step on the ``A_log`` leaves}.  A
    one-step ``run`` is held after its step only."""
    from repro_torch.bridge import is_spec, tree_flatten
    names = ["/".join(map(str, p)) for p in _paths(run["params"])]
    pspecs, mspecs = [tree_flatten(sp, is_leaf=is_spec)[0] if mesh else [None] * len(names)
                      for sp in run["specs"]]
    first = leaf_gaps(run["first"][1], ref["first"][1], mspecs, mesh, names, scaled=True)
    out = dict(params1=max(leaf_gaps(run["first"][0], ref["first"][0], pspecs, mesh,
                                     names, scaled=False))[0],
               a_log=max(g for g, n in first if n.endswith("A_log")),
               moments=max((g, f"mu after step 1: {n}") for g, n in first))
    if len(run["losses"]) == len(ref["losses"]):
        for tag, i, root in (("mu", 0, False), ("sqrt(nu)", 1, True)):
            worst = max(leaf_gaps(run["last"][i], ref["last"][i], mspecs, mesh, names,
                                  scaled=True, root=root))
            out["moments"] = max(out["moments"], (worst[0], f"{tag} after step "
                                                  f"{len(run['losses'])}: {worst[1]}"))
        out["params"] = max(leaf_gaps(tree_flatten(run["params"])[0], ref["params"],
                                      pspecs, mesh, names, scaled=False))[0]
    return out


def shtrain_held(loss_gap, gaps):
    return (loss_gap <= SHTRAIN_REL and gaps["moments"][0] <= SHTRAIN_MOMENTS
            and max(gaps["params1"], gaps.get("params", 0.0)) <= SHTRAIN_ABS)


def gaps_text(loss_gap, gaps):
    out = (f"loss/norm gap {loss_gap:.3e} (limit {SHTRAIN_REL}), moments within "
           f"{gaps['moments'][0]:.3e} of their leaf's largest ({gaps['moments'][1]}; limit "
           f"{SHTRAIN_MOMENTS}; A_log's first moment {gaps['a_log']:.3e}), params within "
           f"{gaps['params1']:.3e} ({gaps['params1'] / SHTRAIN_LR:.2f} lr) after step 1")
    if "params" in gaps:
        out += (f" and {gaps['params']:.3e} ({gaps['params'] / SHTRAIN_LR:.2f} lr) after "
                f"step {SHTRAIN_STEPS}")
    return out + f" (limit {SHTRAIN_ABS})"


@contextlib.contextmanager
def ssd_event_times():
    """CUDA events around each SSD kernel launch and each backward's plain
    recompute (``SSDScan.backward``: ``ssd_chunked`` and its gradient):
    yields {"kernel": [...], "recompute": [...]} of event pairs."""
    from repro_torch.kernels import ssd_scan as ssd
    pairs = {"kernel": [], "recompute": []}
    launch, backward = ssd._launch, ssd.SSDScan.__dict__["backward"]

    def timed(key, fn):
        def run(*a):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a)
            ev[1].record()
            pairs[key].append(ev)
            return out
        return run
    ssd._launch = timed("kernel", launch)
    ssd.SSDScan.backward = staticmethod(timed("recompute", backward.__func__))
    try:
        yield pairs
    finally:
        ssd._launch, ssd.SSDScan.backward = launch, backward


def events_ms(pairs):
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs)


def _shtrain_rank(rank, port, name, n_layers, seed, data, ref, out_dir):
    """(b) and (d) on one of the 2x2 gloo ranks sharing the card: the f32
    steps held against (a)'s (``ref``, its leaves passed over CUDA IPC),
    then the bf16 steps, timed.  Also returns the shapes the rank gave the
    kernels (``shapes_seen``)."""
    import torch.distributed as dist
    from repro_torch.configs import ARCHS, replace
    from repro_torch.launch.mesh import HOST_STAGED, make_local_mesh
    plain_calls = _gloo_init(rank, port, SHTRAIN_MESH[0] * SHTRAIN_MESH[1])
    mesh = make_local_mesh(*SHTRAIN_MESH)
    cfg = replace(ARCHS[name], n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    with shapes_seen() as seen:
        f32 = shtrain_run(cfg, mesh, seed, data, torch.float32)
        peak = torch.cuda.max_memory_allocated()
        gap, gaps = shtrain_gaps(f32, ref), run_gaps(f32, ref, mesh)
        del f32["params"], f32["first"], f32["last"]
        torch.cuda.empty_cache()
        bf16 = shtrain_run(cfg, mesh, seed, data, torch.bfloat16)
        del bf16["params"], bf16["first"], bf16["last"]
    res = dict(rank=rank, gap=gap, gaps=gaps, peak_gb=peak / 1e9,
               losses=f32["losses"], walls=f32["walls"], coll=f32["coll"],
               bf16_walls=bf16["walls"], bf16_coll=bf16["coll"],
               ssd=f32["ssd"] + bf16["ssd"], plain_cuda_calls=plain_calls,
               backend=mesh.backend, staged=sorted(HOST_STAGED),
               shapes={k: sorted(v) for k, v in seen.items()})
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def _witness_rank(rank, port, name, n_layers, seed, data, ref, out_dir):
    """(e) on one of four gloo ranks sharing the card in two meshes of two,
    ranks 0-1 at ``SHTRAIN_WITNESS[0]`` and 2-3 at ``[1]`` (each its own
    world, met through a file in ``out_dir``): one f32 step held against
    (a)'s first."""
    import torch.distributed as dist
    from repro_torch.configs import ARCHS, replace
    from repro_torch.launch.mesh import make_local_mesh
    pair, r = divmod(rank, 2)
    plain_calls = _gloo_init(r, port, 2, init=f"file://{out_dir}/pair{pair}")
    mesh = make_local_mesh(*SHTRAIN_WITNESS[pair])
    cfg = replace(ARCHS[name], n_layers=n_layers)
    with shapes_seen() as seen:
        run = shtrain_run(cfg, mesh, seed, data, torch.float32, steps=1)
        gap, gaps = shtrain_gaps(run, ref), run_gaps(run, ref, mesh)
    res = dict(rank=rank, mesh=SHTRAIN_WITNESS[pair], gap=gap, gaps=gaps, ssd=run["ssd"],
               plain_cuda_calls=plain_calls, shapes={k: sorted(v) for k, v in seen.items()})
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def pp_shape():
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig("pp", seq_len=PP_SEQ, global_batch=PP_MICRO, kind="train")


def pp_data(cfg, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, cfg.vocab, (PP_MICRO, 1, PP_SEQ)) for _ in range(2))


def _pp_rank(rank, port, name, n_layers, seed, data, ref, out_dir):
    """(c) on one of the two pod ranks: the GPipe step from the seed's
    params, held against one device's step (``ref``: loss, grad norm); a
    second step for its wall."""
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.configs import ARCHS, replace
    from repro_torch.launch.mesh import local_block, make_pod_mesh
    from repro_torch.launch.pipeline import make_pp_train_step
    from repro_torch.models import transformer as T
    plain_calls = _gloo_init(rank, port, 2)
    mesh = make_pod_mesh(2, 1, 1)
    cfg = replace(ARCHS[name], n_layers=n_layers)
    step, _, (specs, _, batch, _) = make_pp_train_step(cfg, pp_shape(), mesh,
                                                       n_micro=PP_MICRO)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = bridge.shard_to_torch(T.init_params(cfg, generator=gen, device="cuda"),
                                   specs, mesh, device="cuda")
    torch.cuda.empty_cache()
    state = zero_state(cfg, specs, mesh)
    toks, labels = (torch.as_tensor(local_block(a, batch, mesh), device="cuda")
                    for a in data)
    torch.cuda.reset_peak_memory_stats()
    walls, hops = [], []
    for _ in range(2):
        n0 = mesh.stats.get(("forward", "ring_shift"), [0])[0] + \
            mesh.stats.get(("backward", "ring_shift"), [0])[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, toks, labels)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        hops.append(mesh.stats.get(("forward", "ring_shift"), [0])[0] +
                    mesh.stats.get(("backward", "ring_shift"), [0])[0] - n0)
        if len(walls) == 1:
            loss, norm = float(m["loss"]), float(m["grad_norm"])
    res = dict(rank=rank, loss=loss, norm=norm,
               gap=max(abs(loss - ref[0]) / abs(ref[0]), abs(norm - ref[1]) / abs(ref[1])),
               walls=walls, hops=hops, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               plain_cuda_calls=plain_calls)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def pp_reference(cfg, seed, data):
    """One device's ``make_train_step`` with the pipeline's semantics (bf16,
    remat, the same microbatches, ``AdamWConfig()``), two steps: (the first
    step's loss and grad norm, the two walls in s)."""
    from repro_torch import optim
    from repro_torch.models import transformer as T
    from repro_torch.train import TrainConfig, make_train_step
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, generator=gen, device="cuda")
    ctx = T.ParallelCtx(remat=True, compute_dtype=torch.bfloat16, loss_chunk=256)
    step = make_train_step(cfg, ctx, TrainConfig(microbatches=PP_MICRO,
                                                 compute_dtype=torch.bfloat16))
    toks, labels = (torch.as_tensor(a, device="cuda") for a in data)
    state, walls = optim.init(params), []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, toks, labels)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if len(walls) == 1:
            loss, norm = float(m["loss"]), float(m["grad_norm"])
    return loss, norm, walls


def phase_sharded_training():
    import torch.distributed as dist
    from repro_torch.configs import ARCHS, replace
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.mesh import make_local_mesh
    name, n_layers, seed = SHTRAIN_ARCH
    log(f"phase 14: sharded training (make_train_step on a rank mesh: ZeRO-1, remat "
        f"with the collectives saved, the vocab-sharded loss): full-width {name} "
        f"({n_layers} of 64 layers), f32 with TF32 off, {SHTRAIN_STEPS} steps of "
        f"{SHTRAIN_MICRO} microbatches x {SHTRAIN_BATCH // SHTRAIN_MICRO} x "
        f"{SHTRAIN_SEQ}; on one rank (NCCL) against one device, on 2x2 gloo ranks "
        f"against one rank, then bf16 for timing; one step on 2x1 and 1x2; the GPipe "
        f"step; then every shape the path gave the SSD kernel against its plain version")
    cfg = replace(ARCHS[name], n_layers=n_layers)
    data = shtrain_data(cfg, seed)
    tokens = SHTRAIN_BATCH * SHTRAIN_SEQ
    t0 = time.perf_counter()
    with off_path():
        one = shtrain_run(cfg, None, seed, data, torch.float32)
        # the floor: one device against itself
        again = shtrain_run(cfg, None, seed, data, torch.float32)
    floor = params_gap(again["params"], one["params"])
    del again
    # (a) one rank, a 1x1 mesh over NCCL
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    mesh = make_local_mesh(1, 1)
    with shapes_seen() as seen:
        with ssd_event_times() as ev32:
            a = shtrain_run(cfg, mesh, seed, data, torch.float32)
        gap, gaps = shtrain_gaps(a, one), run_gaps(a, as_ref(one))
        del one
        torch.cuda.empty_cache()
        with ssd_event_times() as ev16:
            a16 = shtrain_run(cfg, mesh, seed, data, torch.bfloat16)
        del a16["params"], a16["first"], a16["last"]
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    scan = [f"{k} {events_ms(ev[k]) / SHTRAIN_STEPS:.1f} ms ({len(ev[k]) // SHTRAIN_STEPS})"
            for ev in (ev32, ev16) for k in ("kernel", "recompute")]
    log(f"  one device against itself: params within {floor:.3e} after "
        f"{SHTRAIN_STEPS} steps")
    log(f"  (a) one rank: losses {[round(x, 6) for x in a['losses']]}, grad norms "
        f"{[round(x, 6) for x in a['norms']]}; against one device: "
        f"{gaps_text(gap, gaps)}; step wall "
        f"{[round(1e3 * w, 1) for w in a['walls']]} ms f32, "
        f"{[round(1e3 * w, 1) for w in a16['walls']]} ms bf16 "
        f"({tokens / float(np.median(a16['walls'][1:])):.0f} tokens/s); "
        f"{a['ssd'] // SHTRAIN_STEPS} SSD launches a step; a step's SSD kernel and the "
        f"backward's plain recompute (calls), f32: {scan[0]}, {scan[1]}; bf16: {scan[2]}, "
        f"{scan[3]}")
    if not shtrain_held(gap, gaps):
        fail(f"sharded training: one rank differs from one device ({gap:.3e}, {gaps})")
    log(f"  one device and (a): {time.perf_counter() - t0:.1f} s wall")
    # (b) + (d) four ranks sharing the card over gloo
    t0 = time.perf_counter()
    ref = as_ref(a)
    del a
    res = run_ranks(_shtrain_rank, (name, n_layers, seed, data, ref), name,
                    world=SHTRAIN_MESH[0] * SHTRAIN_MESH[1])
    gap = max(r["gap"] for r in res)
    gaps = dict(params1=max(r["gaps"]["params1"] for r in res),
                params=max(r["gaps"]["params"] for r in res),
                a_log=max(r["gaps"]["a_log"] for r in res),
                moments=max(tuple(r["gaps"]["moments"]) for r in res))
    med = lambda xs: float(np.median(xs[1:]))  # noqa: E731
    coll = res[0]["coll"][-1]
    log(f"  (b) 2x2 gloo ranks on one card: against (a): {gaps_text(gap, gaps)}; step "
        f"wall (median of steps 2-{SHTRAIN_STEPS}) "
        f"{[round(1e3 * med(r['walls']), 1) for r in res]} ms f32 "
        f"({tokens / max(med(r['walls']) for r in res):.0f} tokens/s); collective calls "
        f"a step {coll[0]} forward + {coll[1]} backward (remat's recompute included), "
        f"host wall inside them {[round(r['coll'][-1][2], 1) for r in res]} ms; peak "
        f"allocated {[round(r['peak_gb'], 2) for r in res]} GB; SSD launches "
        f"{[r['ssd'] for r in res]}; staged through the host on {res[0]['backend']}: "
        f"{res[0]['staged']}")
    log(f"  (d) the same on bf16 compute: step wall "
        f"{[round(1e3 * med(r['bf16_walls']), 1) for r in res]} ms "
        f"({tokens / max(med(r['bf16_walls']) for r in res):.0f} tokens/s), host wall "
        f"in collectives {[round(r['bf16_coll'][-1][2], 1) for r in res]} ms a step")
    if not shtrain_held(gap, gaps):
        fail(f"sharded training: four ranks differ from one ({gap:.3e}, {gaps})")
    log(f"  (b) and (d): {time.perf_counter() - t0:.1f} s wall")
    # (e) the witnesses: one step on data only and on model only, two
    # meshes of two ranks at once
    t0 = time.perf_counter()
    wit = run_ranks(_witness_rank, (name, n_layers, seed, data, ref), name, world=4)
    del ref
    torch.cuda.empty_cache()
    for pair in (0, 1):
        two = wit[2 * pair:2 * pair + 2]
        wgap = max(r["gap"] for r in two)
        wgaps = dict(params1=max(r["gaps"]["params1"] for r in two),
                     a_log=max(r["gaps"]["a_log"] for r in two),
                     moments=max(tuple(r["gaps"]["moments"]) for r in two))
        shape = "x".join(map(str, two[0]["mesh"]))
        log(f"  (e) {shape} (data x model) gloo ranks, one step, against (a)'s first: "
            f"{gaps_text(wgap, wgaps)}; SSD launches {[r['ssd'] for r in two]}")
        if not shtrain_held(wgap, wgaps):
            fail(f"sharded training: {shape} ranks differ from one ({wgap:.3e}, {wgaps})")
    log(f"  (e): {time.perf_counter() - t0:.1f} s wall")
    for r in res + wit:
        ssd.ssd_scan.launches += r["ssd"]
        for key in PLAIN_CUDA_CALLS:
            PLAIN_CUDA_CALLS[key] += r["plain_cuda_calls"].get(key, 0)
        for key in seen:
            seen[key].update(tuple(k) for k in r["shapes"][key])
    if not all(r["ssd"] > 0 for r in res + wit):
        fail("sharded training: a rank launched no SSD scan")
    # (c) GPipe over two pod ranks
    t0 = time.perf_counter()
    name, n_layers, seed = PP_ARCH
    cfg = replace(ARCHS[name], n_layers=n_layers)
    data = pp_data(cfg, seed)
    with off_path():
        ref = pp_reference(cfg, seed, data)
    torch.cuda.empty_cache()
    res = run_ranks(_pp_rank, (name, n_layers, seed, data, ref[:2]), name, world=2)
    gap = max(r["gap"] for r in res)
    log(f"  (c) GPipe {name} ({n_layers} of 40 layers, {n_layers // 2} a stage), {PP_MICRO} "
        f"microbatches of 1 x {PP_SEQ}, bf16, pod 2 (gloo, one card): loss "
        f"{res[0]['loss']:.6f} grad norm {res[0]['norm']:.6f} against one device's "
        f"{ref[0]:.6f} {ref[1]:.6f} (largest gap {gap:.3e}, limit {PP_REL}); step wall "
        f"of the second step {[round(1e3 * r['walls'][1], 1) for r in res]} ms (one "
        f"device {1e3 * ref[2][1]:.1f} ms, its first {1e3 * ref[2][0]:.1f}); hops a step "
        f"{[r['hops'] for r in res]}; peak {[round(r['peak_gb'], 2) for r in res]} GB")
    log(f"  (c): {time.perf_counter() - t0:.1f} s wall")
    if gap > PP_REL:
        fail(f"GPipe: the pipeline differs from one device ({gap:.3e})")
    if any(r["hops"] != [2 * PP_MICRO + 1] * 2 for r in res):
        fail(f"GPipe: hops {[r['hops'] for r in res]}, not {2 * PP_MICRO + 1} a step")
    if any(any(r["plain_cuda_calls"].values()) for r in res):
        fail("GPipe: plain versions ran on CUDA tensors")
    with off_path():
        hold_seen(seen, 14, ("ssd",))


# phase 15: the dry run's roofline beside the card, and the port's examples
ROOFLINE_WARM = 1            # steps before the timed one


# --------------------------------------------------------------------------
# Phase 16: granite-4.0-h-small, Mamba-2 and attention layers with a
# dropless MoE over one chip's share of the experts
# --------------------------------------------------------------------------

G4H_LAYERS = 6            # the first 6 of 40: 5 Mamba-2 layers and 1 NoPE attention


def granite4h_model(n_layers, seed):
    """The benchmark's granite-4.0-h-small configuration (its ``port``
    block: full widths, 18 of 72 experts held, Granite's multipliers) cut
    to its first ``n_layers`` layers, with bf16 weights from ``seed``."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import transformer as T
    path = Path(__file__).resolve().parent / "valetbench" / "configs" / \
        "granite-4.0-h-small.json"
    with open(path) as fh:
        c = json.load(fh)
    port = dict(c["port"], n_layers=n_layers,
                layer_pattern=c["port"]["layer_pattern"][:n_layers])
    cfg = ArchConfig(name=c["name"], **port)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, generator=gen, dtype=torch.bfloat16, device="cuda")
    return cfg, params, T.ParallelCtx(remat=False, compute_dtype=torch.bfloat16)


def dropless_check(cfg, params, t=128):
    """One MoE layer's dropless call at the cell's decode shape (``t`` rows,
    a quarter of them inactive): the entries counted on the device are
    those the router sends to the held experts from active rows, and row
    0's output keeps its bits with the other rows holding other states,
    inactive, and on a repeat."""
    from repro_torch.models import moe as M
    from repro_torch.models.decode import layer_infos, layer_params
    info = next(i for i in layer_infos(cfg) if i.ffn == "moe")
    p = layer_params(params, info)["moe"]
    moe = cfg.moe
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((t, cfg.d_model), device="cuda", generator=g).to(torch.bfloat16)
    active = torch.rand((t,), device="cuda", generator=g) > 0.25
    active[0] = True
    counts = []
    with M.tally(counts):
        out = M.moe_ffn_dropless(p, x, moe, active=active, with_aux=False)
    eids = M.router_topk(p, x, moe)[0]
    mine = (eids >= moe.held_first) & (eids < moe.held_first + moe.held) & active[:, None]
    want = torch.bincount((eids[mine] - moe.held_first), minlength=moe.held)
    if not torch.equal(counts[0], want):
        fail(f"dropless MoE: entries counted {counts[0].tolist()} are not those routed "
             f"to the held experts {want.tolist()}")
    other = torch.randn((t, cfg.d_model), device="cuda", generator=g).to(torch.bfloat16)
    other[0] = x[0]
    alone = torch.zeros_like(active)
    alone[0] = True
    for what, xs, act in (("with the other rows changed", other, active),
                          ("with the other rows inactive", x, alone),
                          ("on a repeat", x.clone(), active)):
        got = M.moe_ffn_dropless(p, xs, moe, active=act, with_aux=False)[0]
        if not torch.equal(got, out[0]):
            fail(f"dropless MoE: row 0 differs {what} (max abs diff "
                 f"{max_err(got, out[0]):.3e})")
    log(f"  dropless MoE check (layer {info.seg}.{info.idx}, {t} rows, "
        f"{int(active.sum())} active): {int(want.sum())} entries routed to the "
        f"{moe.held} held experts, all counted and computed; row 0 bit-identical "
        f"with the other rows changed, inactive and on a repeat")


def phase_granite4h():
    log(f"phase 16: full-width granite-4.0-h-small ({G4H_LAYERS} of 40 layers: 5 "
        "Mamba-2, 1 NoPE attention; in each a dropless MoE over experts 0-17 of 72, "
        "top-10, and the shared expert), Granite's multipliers, bf16, f32 KV pool")
    cfg, params, ctx = granite4h_model(G4H_LAYERS, seed=16)
    n = sum(t.numel() for t in _leaves(params))
    log(f"  params {n / 1e9:.3f} B")
    with off_path():
        dropless_check(cfg, params)
    rng = np.random.default_rng(16)
    lens = [int(x) for x in rng.choice([128, 512, 1100], size=12)]
    prompts = [rng.integers(2, cfg.vocab, size=x) for x in lens]
    geom = dict(max_batch=8, max_seq=1152, page=16, max_new=32)
    slots, need = pressured_slots(prompts, geom["max_batch"], geom["page"])
    log(f"  prompts {lens}; the first 8 need {need} pages, pressured at {slots}")
    torch.cuda.reset_peak_memory_stats()
    ref = None
    for label, s in (("no pressure", 640), ("valet zero-restore", slots)):
        outs, st, wall = run_engine(params, cfg, ctx, prompts, policy="valet",
                                    pool_slots=s, device="cuda", **geom)
        log(f"  granite-4.0-h-small {label} ({s} slots): "
            f"{sum(len(o) for o in outs)} tokens in {wall:.3f} s wall; {stats_line(st)}; "
            f"moe entries {st.moe_entries} groups {st.moe_groups}")
        if st.moe_entries <= 0 or st.moe_groups <= 0:
            fail(f"granite-4.0-h-small {label}: no MoE entries counted")
        if ref is None:
            ref = outs
        elif outs != ref:
            fail(f"granite-4.0-h-small {label}: tokens differ from the unpressured run")
        elif st.pauses <= 0:
            fail(f"granite-4.0-h-small {label}: pressure did not preempt")
    log(f"  granite-4.0-h-small: tokens identical under pressure; "
        f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    gm = {k: v for k, v in geom.items() if k != "max_new"}
    with off_path():
        profile_decode("granite-4.0-h-small", cfg, params, ctx, prompts, pool_slots=640,
                       **gm)
        profile_prefill("granite-4.0-h-small", cfg, params, ctx,
                        rng.integers(2, cfg.vocab, size=1100))
    del params
    torch.cuda.empty_cache()


def example_module(name):
    """``examples/<name>.py`` of this checkout, imported by path."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def roofline_beside_card():
    """Phase 14's one-rank train cell (``build_train_cell`` on a 1x1 mesh:
    bf16 compute, remat, ZeRO-1, loss chunks of 256) on the card, one warm
    step then one timed with CUDA events and the peak allocated across it;
    then ``analyze_cell`` on the same cell on meta.  The peak is read
    above what the card held before the cell's tensors were made (what
    earlier phases left allocated).  Returns the record."""
    from repro_torch import optim
    from repro_torch.configs import ARCHS, replace
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.roofline import RooflineTerms
    name, n_layers, seed = SHTRAIN_ARCH
    cfg = replace(ARCHS[name], n_layers=n_layers)
    shape = ShapeConfig("phase14", seq_len=SHTRAIN_SEQ, global_batch=SHTRAIN_BATCH,
                        kind="train")
    axes = ("data", "model")
    cell = specs.build_train_cell(cfg, shape, Mesh((1, 1), axes, rank=0))
    nm = cell.meta["microbatches"]
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, generator=gen, device="cuda")
    state = optim.init(params)
    rng = np.random.default_rng(seed)
    toks, labels = (torch.as_tensor(rng.integers(0, cfg.vocab, (nm, SHTRAIN_BATCH // nm,
                                                                 SHTRAIN_SEQ)),
                                    dtype=torch.int32, device="cuda") for _ in range(2))
    for _ in range(ROOFLINE_WARM):
        params, state, m = cell.fn(params, state, toks, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    params, state, m = cell.fn(params, state, toks, labels)
    end.record()
    torch.cuda.synchronize()
    wall_s = start.elapsed_time(end) / 1e3
    peak = torch.cuda.max_memory_allocated() - held
    loss = float(m["loss"])
    del params, state, m
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry = Mesh((1, 1), axes, rank=0, dry=True)
    rec = dryrun.analyze_cell(specs.build_train_cell(cfg, shape, dry), dry)
    analysis_s = time.perf_counter() - t0
    r = rec["roofline"]
    terms = RooflineTerms(r["flops_per_chip"], r["hbm_bytes_per_chip"],
                          r["collective_bytes_per_chip"], r["model_flops_per_chip"])
    arg_b = rec["memory"]["argument_bytes"]
    log(f"  (a) {name} ({n_layers} of 64 layers) train cell, {nm} microbatches of "
        f"{SHTRAIN_BATCH // nm} x {SHTRAIN_SEQ}, bf16 compute, 1x1: loss {loss:.6f}; "
        f"dry run on meta in {analysis_s:.1f} s: {r['flops_per_chip'] / 1e12:.3f} TFLOP "
        f"counted (model {r['model_flops_per_chip'] / 1e12:.3f}), "
        f"{r['hbm_bytes_per_chip'] / 1e9:.3f} GB HBM (analytic); bound "
        f"{1e3 * terms.bound_time:.3f} ms ({terms.bottleneck}: compute "
        f"{1e3 * terms.t_compute:.3f}, memory {1e3 * terms.t_memory:.3f} ms); "
        f"measured step {1e3 * wall_s:.3f} ms (CUDA events, after {ROOFLINE_WARM} warm): "
        f"roofline share {terms.bound_time / wall_s:.4f}; argument bytes {arg_b} "
        f"({arg_b / 1e9:.3f} GB) beside the measured peak {peak} ({peak / 1e9:.3f} GB, "
        f"above the {held / 1e9:.3f} GB held before the cell)")
    if not np.isfinite(loss):
        fail(f"phase 15: the train cell's loss is {loss}")
    if arg_b > peak:
        fail(f"phase 15: the dry run's argument bytes {arg_b} exceed the measured peak {peak}")
    return dict(bound_ms=1e3 * terms.bound_time, wall_ms=1e3 * wall_s, peak=peak,
                argument_bytes=arg_b, analysis_s=analysis_s)


def examples_on_card():
    """``examples/policy_comparison_torch.py`` (reduced granite-3-8b, every
    policy must be exact) and ``examples/fault_tolerance_torch.py`` (reduced
    phi3-mini: the restore exact, no page lost), each on its seed-0 weights
    on the card."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import transformer as T
    for name, arch in (("policy_comparison_torch", "granite-3-8b"),
                       ("fault_tolerance_torch", "phi3-mini-3.8b")):
        cfg = reduced(ARCHS[arch])
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = T.init_params(cfg, generator=gen, device="cuda")
        t0 = time.perf_counter()
        res = example_module(name).run(params, cfg, "cuda")
        wall = time.perf_counter() - t0
        if name == "policy_comparison_torch":
            exact = {p: outs == res["valet"][0] for p, (outs, _) in res.items()}
            log(f"  (b) {name}: exact {exact}, {wall:.1f} s")
            if not all(exact.values()):
                fail(f"phase 15: {name}: a policy's tokens differ ({exact})")
        else:
            log(f"  (b) {name}: restore exact {res['exact']} (step {res['restore_step']}), "
                f"{res['recovered']} pages recovered, {res['lost']} lost, {wall:.1f} s")
            if not res["exact"] or res["lost"] or res["restore_step"] != 20:
                fail(f"phase 15: {name}: restore exact {res['exact']}, step "
                     f"{res['restore_step']}, {res['lost']} pages lost")


def phase_dryrun():
    log("phase 15: the meta-device dry run's roofline beside the card (phase 14's "
        "one-rank train cell) and the port's last two examples on the card, then every "
        "shape the phase gave a kernel against its plain version")
    with shapes_seen() as seen:
        rec = roofline_beside_card()
        examples_on_card()
    with off_path():
        hold_seen(seen, 15, ("paged", "flash", "ssd"))
    return rec


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import host_pages as hp
    from repro_torch.kernels import kv_append as kva
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ssd

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    log("phase 1: build")
    path, seconds, build_log = cuda_lib.build(verbose=True)
    log(f"  nvcc {seconds:.2f} s -> {path.name}")
    for line in build_log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")) or \
                "error" in line.lower():
            log(f"  ptxas: {line.strip()}")
    cuda_lib.load()
    phase_sass(path)

    log(f"  phase 1: {time.perf_counter() - t_start:.1f} s wall")
    recs = {}
    if 2 in phases:
        t0 = time.perf_counter()
        recs = phase_kernels()
        log(f"  phase 2: {time.perf_counter() - t0:.1f} s wall")
    if 3 in phases:
        t0 = time.perf_counter()
        phase_reduced()
        log(f"  phase 3: {time.perf_counter() - t0:.1f} s wall")

    # phases 4-14 are the main paths.  Each runs with every launch count and
    # every count of plain-version calls on CUDA tensors set to 0 just
    # before it, and read just after; the profiles and checks a phase runs
    # beside its serving runs are off the path (``off_path``)
    wrappers = {"paged": (pa, "paged_attention"),
                "paged_partials": (pa, "paged_attention_partials"),
                "flash": (fa, "flash_attention"), "ssd": (ssd, "ssd_scan"),
                "host_pages": (hp, "host_pages"), "moe_gemm": (mg, "moe_gemm"),
                "kv_append": (kva, "kv_append")}
    plain_cuda_calls = PLAIN_CUDA_CALLS

    def counting(fn, key):
        def wrapped(x, *a, **kw):
            plain_cuda_calls[key] += int(x.is_cuda)
            return fn(x, *a, **kw)
        return wrapped

    for key, (mod, fn) in wrappers.items():
        setattr(mod, fn + "_plain", counting(getattr(mod, fn + "_plain"), key))
    # granite's pressured runs (zero-restore, legacy, os-swap) move pages
    # to the host arena and back through the host-tier kernel
    # an engine's decode step appends through kv_append on every paged arch
    main_paths = [(4, "granite-3-8b", phase_granite,
                   ("paged", "flash", "host_pages", "kv_append")),
                  (5, "gemma3-4b", phase_gemma, ("paged", "flash")),
                  (6, "hymba-1.5b", phase_hymba, ("paged", "flash", "ssd")),
                  (7, "mamba2-2.7b", phase_mamba2, ("ssd",)),
                  (8, "multi-tenant granite-3-8b", phase_tenants, ("paged", "flash")),
                  (9, "deepseek-moe-16b", phase_deepseek, ("paged", "flash")),
                  (10, "llama-3.2-vision-11b and whisper-large-v3", phase_cross,
                   ("paged", "flash")),
                  # training keeps attention on the differentiable blockwise
                  # path, as the reference does (neither package has a flash
                  # backward), so granite's steps launch none of the three
                  # kernels; mamba2's launch the SSD scan forward
                  (11, "training granite-3-8b and mamba2-2.7b", phase_training, ("ssd",)),
                  # the sharded serve step reads the pools through the partial
                  # entry only; four ranks' launches come back from them
                  (12, "sharded serve step granite-3-8b and gemma3-4b", phase_sharded,
                   ("paged_partials",)),
                  # the prefill cell runs flash on each rank's heads and SSD on
                  # its SSD heads; the decode reads pools through the partial
                  # entry; four ranks' launches come back from them
                  (13, "sharded prefill and serve step hymba-1.5b, deepseek-moe-16b "
                   "and whisper-large-v3", phase_kinds, ("flash", "ssd", "paged_partials")),
                  # sharded training runs each rank's SSD heads on the SSD
                  # kernel under autograd; the ranks' launches come back
                  # from them (the GPipe step is granite's: no kernel)
                  (14, "sharded training mamba2-2.7b and GPipe granite-3-8b",
                   phase_sharded_training, ("ssd",)),
                  # the train cell beside its dry run launches the SSD scan;
                  # the policy comparison's engines prefill through flash
                  # and decode through paged (the dry run itself runs the
                  # plain versions on meta tensors)
                  (15, "dry-run roofline mamba2-2.7b and the examples", phase_dryrun,
                   ("paged", "flash", "ssd")),
                  # the Mamba-2 layers prefill on the SSD kernel, the attention
                  # layer on flash and paged, every layer's experts on the
                  # grouped GEMM
                  (16, "granite-4.0-h-small", phase_granite4h,
                   ("paged", "flash", "ssd", "moe_gemm"))]
    path_recs = {}
    launches = dict.fromkeys(wrappers, 0)
    for num, name, run_path, used in main_paths:
        if num not in phases:
            continue
        # the previous path's engines may sit in reference cycles (a tenant's
        # coordinator holds its donate callback): free their device memory
        # before this path's peak is read
        gc.collect()
        torch.cuda.empty_cache()
        for key, (mod, fn) in wrappers.items():
            getattr(mod, fn).launches = 0
            plain_cuda_calls[key] = 0
        t0 = time.perf_counter()
        path_recs[num] = run_path()
        counts = {key: getattr(mod, fn).launches for key, (mod, fn) in wrappers.items()}
        log(f"  phase {num}: {time.perf_counter() - t0:.1f} s wall; {name} main "
            f"path kernel launches {counts}, plain-version calls on CUDA tensors "
            f"{plain_cuda_calls}")
        missing = [k for k in used if counts[k] <= 0]
        if missing:
            fail(f"{name}: kernels {missing} were not launched on its main path")
        if any(plain_cuda_calls.values()):
            fail(f"{name}: plain versions ran on CUDA tensors: {plain_cuda_calls}")
        for key in launches:
            launches[key] += counts[key]
    log(f"main paths: kernel launches {launches}; {time.perf_counter() - t_start:.1f} s "
        f"wall in all")

    kernels = []
    if 2 in phases:
        p = recs[("paged", torch.bfloat16, torch.float32)]
        f = recs[("flash", 512, torch.bfloat16)]
        d = recs[("ssd", "mamba2", torch.bfloat16)]
        kernels = [
            # the partial entry is the same source's other entry: its own
            # line counts its launches, and the sum of both stands apart
            dict(name="paged_attention", route="cuda",
                 source="src/repro_torch/csrc/paged_attention.cu",
                 replaces="src/repro/kernels/paged_attention.py:87",
                 launches=launches["paged"],
                 launches_with_partials=launches["paged"] + launches["paged_partials"],
                 **p),
            dict(name="flash_attention", route="cuda",
                 source="src/repro_torch/csrc/flash_attention_tc.cu",
                 replaces="src/repro/kernels/flash_attention.py:88",
                 launches=launches["flash"], **f),
            dict(name="ssd_scan", route="cuda",
                 source="src/repro_torch/csrc/ssd_scan.cu",
                 replaces="src/repro/kernels/ssd_scan.py:25",
                 launches=launches["ssd"], **d),
        ]
        for n in (45, 140):
            kernels.append(dict(name="host_pages", route="cuda",
                                source="src/repro_torch/csrc/host_pages.cu",
                                replaces=None, launches=launches["host_pages"],
                                **recs[("host_pages", n)]))
        for shape in ("decode", "prefill"):
            kernels.append(dict(name="moe_gemm", shape=shape, route="cuda",
                                source="src/repro_torch/csrc/moe_gemm.cu",
                                replaces=None, launches=launches["moe_gemm"],
                                **recs[("moe", shape)]))
        kernels.append(dict(name="kv_append", route="cuda",
                            source="src/repro_torch/csrc/kv_append.cu", replaces=None,
                            launches=launches["kv_append"], **recs[("kv_append",)]))
    if path_recs.get(12) is not None:
        kernels.append(dict(name="paged_attention_partials", route="cuda",
                            source="src/repro_torch/csrc/paged_attention.cu",
                            replaces="src/repro/kernels/paged_attention.py:87",
                            launches=launches["paged_partials"], **path_recs[12]))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
