"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/csrc`` and
counts the tensor-core instructions in each kernel's SASS (phase 1), holds
each kernel against its plain PyTorch version on the card and checks that
two calls give the same bits and that a row of the paged kernel keeps its
bits when the other rows of its batch change (phase 2), checks
the port's CUDA path against its CPU path on reduced configs (phase 3), then
drives the main paths through ``ValetServeEngine`` with and without
KV-pool pressure: full-width granite-3-8b (20 of 40 layers, every policy;
phase 4), full-width gemma3-4b at 6 layers with prompts past its 1024-token
window (phase 5), full-width hymba-1.5b (all 32 layers: paged, ring and SSD
state together; phase 6) and full-width mamba2-2.7b (all 64 layers, SSD
state only; phase 7).  Each main path runs with every kernel's launch count
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


def device_ms(fn, reps=20, flush=None):
    """Device time of one call of ``fn``: the summed time of the CUDA kernels
    it launches, from ``torch.profiler`` over ``reps`` calls after a warm-up.
    Unlike ``time_ms`` it leaves out the host time of the call (a wrapper's
    checks, allocations and launches), which events around a single call
    include when the device waits for the host.  ``flush()`` runs before
    each call; its own kernels' time, measured alone, is taken off."""
    from torch.profiler import ProfilerActivity, profile

    def kernels_us(f):
        f()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                f()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    def measure():
        if flush is None:
            return kernels_us(fn) / reps / 1e3
        both = kernels_us(lambda: (flush(), fn()))
        return (both - kernels_us(flush)) / reps / 1e3

    # the profiler now and then returns a window without its kernel events
    for _ in range(3):
        ms = measure()
        if ms > 0:
            return ms
    fail("device_ms: the profiler recorded no kernel time in three windows")


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


def paged_case(name, b, hq, hkv, d, page, max_len, q_dtype, kv_dtype, seed, **rows):
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
    # live tokens only: pages behind a -1 slot are never read
    live = sum(max(0, min(page, int(lengths[i]) - pi * page))
               for i in range(b) for pi in range(p) if bt[i, pi] >= 0)
    kv_el = torch.finfo(kv_dtype).bits // 8
    q_el = torch.finfo(q_dtype).bits // 8
    n_bytes = 2 * live * hkv * d * kv_el + 2 * b * hq * d * q_el + bt.nbytes + lengths.nbytes
    n_ops = 4 * live * (hq // hkv) * hkv * d
    flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    kernel_fn = lambda: pa.paged_attention(q, kp, vp, btt, lt)  # noqa: E731
    plain_fn = lambda: pa.paged_attention_plain(q, kp, vp, btt, lt)  # noqa: E731
    times = timings(kernel_fn, plain_fn, None, flush=flush_buf.zero_)
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


def band_mask(s, causal, window, dev):
    """(s, s) boolean mask of the (query, key) pairs attention reads."""
    i = torch.arange(s, device=dev)
    mask = torch.ones((s, s), dtype=torch.bool, device=dev)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window > 0:
        mask &= i[None, :] > i[:, None] - window
    return mask


def flash_case(name, hq, hkv, d, s, causal, window, dtype, seed):
    """The flash kernel against its plain version and SDPA, q (hq, s, d) and
    k/v (hkv, s, d): one prefill of one sequence, every head."""
    from repro_torch.kernels import flash_attention as fa
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((hq, s, d), device=dev, generator=g).to(dtype)
    k = torch.randn((hkv, s, d), device=dev, generator=g).to(dtype)
    v = torch.randn((hkv, s, d), device=dev, generator=g).to(dtype)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert_close(name, out, ref, dtype)
    assert_repeatable(name, [out], [fa.flash_attention(q, k, v, causal=causal,
                                                       window=window)])
    mask = band_mask(s, causal, window, dev)
    pairs = int(mask.sum())
    el = torch.finfo(dtype).bits // 8
    n_bytes = (2 * hq + 2 * hkv) * s * d * el
    n_ops = 4 * pairs * hq * d
    # library yardstick: one SDPA call on the same inputs (KV heads expanded
    # to the query heads beforehand; the mask as a boolean band)
    grp = hq // hkv
    q4 = q[None]
    k4 = k.repeat_interleave(grp, dim=0)[None]
    v4 = v.repeat_interleave(grp, dim=0)[None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window > 0 or not causal:
        lib_fn = lambda: sdpa(q4, k4, v4, attn_mask=mask)  # noqa: E731
    else:
        lib_fn = lambda: sdpa(q4, k4, v4, is_causal=True)  # noqa: E731
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


def ssd_case(name, b, s, h, p, g, n, chunk, dtype, seed, s_real=None):
    """The SSD kernel against its plain version on model-like inputs: the
    init's decay A = -linspace(1, 16) and dt = softplus(N(0, 0.5^2) +
    dt_bias); steps past ``s_real`` are the zero padding of a prefill."""
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


def phase_kernels():
    log("phase 2: kernels against their plain versions on the card (ms: CUDA "
        "events around one call, the wrapper's host cost included whenever "
        "the card waits for it; device: the summed time of the kernels the "
        "call launches, torch.profiler)")
    recs = {}
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


def phase_reduced():
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    log("phase 3: reduced configs, CUDA (kernels) against CPU (plain), f32")
    ctx = T.ParallelCtx(remat=False, q_block=8, kv_block=8, loss_chunk=8)
    for name in ("granite-3-8b", "gemma3-4b", "mamba2-2.7b", "hymba-1.5b"):
        cfg = reduced(ARCHS[name])
        gen = torch.Generator().manual_seed(0)
        cpu = T.init_params(cfg, generator=gen, device="cpu")
        gpu = to_device(cpu, "cuda")
        rng = np.random.default_rng(0)
        b, s, n_dec, page = 2, 12, 6, 4
        toks = rng.integers(0, cfg.vocab, size=(b, s + n_dec))
        max_pages = (s + n_dec + page - 1) // page + 1
        bt = np.arange(b * max_pages, dtype=np.int32).reshape(b, max_pages)
        worst = 0.0
        logits = {}
        for dev, params in (("cpu", cpu), ("cuda", gpu)):
            caches = D.init_caches(cfg, b, pool_slots=b * max_pages + 2, page=page,
                                   device=dev)
            lg, caches = D.prefill(params, torch.from_numpy(toks[:, :s]), cfg, ctx,
                                   caches, torch.from_numpy(bt))
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
    ``exact`` run's tokens must equal its tokens."""
    torch.cuda.reset_peak_memory_stats()
    ref, problems = None, []
    for label, policy, slots, zero, exact in runs:
        outs, st, wall = run_engine(params, cfg, ctx, prompts, policy=policy,
                                    pool_slots=slots, zero_restore=zero,
                                    device="cuda", **geom)
        n_tok = sum(len(o) for o in outs)
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
    the model directly) are left out of the main path's launch counts."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ssd
    wrappers = (fa.flash_attention, pa.paged_attention, ssd.ssd_scan)
    before = [w.launches for w in wrappers]
    try:
        yield
    finally:
        for w, n in zip(wrappers, before):
            w.launches = n


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
    mask = band_mask(q.shape[1], causal, window, q.device)
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


def phase_granite():
    from repro_torch.configs import ARCHS, replace
    from repro_torch.models import transformer as T
    # depth cut to 20 of 40 layers so that every main path fits the run's
    # time; the pool pressure is per page, so the preemptions are unchanged
    log("phase 4: full-width granite-3-8b at 20 of 40 layers, f32 KV pool")
    cfg = replace(ARCHS["granite-3-8b"], n_layers=20)
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
                     pressured, True, False)]
        else:
            runs = [(f"{tag} no pressure (512 slots)", "valet", 512, True, True),
                    (f"infiniswap {tag} ({pressured} slots)", "infiniswap",
                     pressured, True, True)]
        serve_full("granite-3-8b", cfg, params, ctx, prompts, runs, **geom)
        if dtype == torch.bfloat16:
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
    return [(f"no pressure ({free} slots)", "valet", free, True, True),
            (f"valet zero-restore ({slots} slots)", "valet", slots, True, True),
            (f"valet legacy ({slots} slots)", "valet", slots, False, True),
            (f"valet-mass ({slots} slots)", "valet-mass", slots, True, True),
            (f"os-swap ({slots} slots)", "os-swap", slots, True, True),
            (f"infiniswap ({slots} slots)", "infiniswap", slots, True, False)]


def bf16_model(name, seed):
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    cfg = ARCHS[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, generator=gen, dtype=torch.bfloat16, device="cuda")
    n = sum(t.numel() for t in _leaves(params))
    log(f"  bf16 weights and compute: params {n / 1e9:.3f} B ({2 * n / 1e9:.2f} GB "
        f"if all bf16; the SSM's A_log, D and dt_bias stay f32)")
    return cfg, params, T.ParallelCtx(remat=False, compute_dtype=torch.bfloat16)


def phase_hymba():
    log("phase 6: full-width hymba-1.5b (32 layers: 3 global paged, 29 "
        "sliding-window rings, SSD state in every layer), bf16, f32 KV pool, "
        "prompts past the 1024 window")
    cfg, params, ctx = bf16_model("hymba-1.5b", seed=2)
    rng = np.random.default_rng(2)
    # 1100-1300 tokens, none a multiple of the 256-step chunk
    lens = [int(n + (n % 256 == 0)) for n in rng.integers(1100, 1301, size=12)]
    prompts = [rng.integers(2, cfg.vocab, size=int(n)) for n in lens]
    geom = dict(max_batch=8, max_seq=1344, page=16)
    slots, need = pressured_slots(prompts, geom["max_batch"], geom["page"])
    log(f"  prompts {lens}; the first 8 need {need} pages, pressured at {slots}")
    serve_full("hymba-1.5b", cfg, params, ctx, prompts, exact_runs(slots, 1024),
               max_new=32, **geom)
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
    rings) leaving for the host tier on a pause (``_read_seq_blob``: pinned
    copies, one synchronisation) and coming back on a resume
    (``_write_seq_blob``), and that the round trip is exact."""
    from repro_torch.serve import ValetServeEngine
    eng = ValetServeEngine(params, cfg, ctx, max_batch=1, max_seq=len(prompt) + 8,
                           page=16, pool_slots=128, device="cuda")
    rid = eng.submit(prompt, max_new=4)
    eng.step()                        # prefill + one decode step
    slot = eng._requests[rid].slot

    def slot_state():
        for c in eng.caches["layers"]:
            if "ring" in c:
                yield from (c["ring"].k[slot], c["ring"].v[slot])
            if "ssm" in c:
                yield from (c["ssm"]["h"][slot], c["ssm"]["conv"][slot])

    before = [t.clone() for t in slot_state()]
    n_bytes = sum(t.numel() * t.element_size() for t in before)
    reads, writes = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = eng._read_seq_blob(slot)
        t1 = time.perf_counter()
        for t in slot_state():
            t.zero_()
        eng._write_seq_blob(slot, blob)
        torch.cuda.synchronize()
        reads.append(t1 - t0)
        writes.append(time.perf_counter() - t1)
    if not all(torch.equal(t, b) for t, b in zip(slot_state(), before)):
        fail(f"{name}: the per-slot state did not round-trip through the host tier")
    rd, wr = 1e3 * np.median(reads[1:]), 1e3 * np.median(writes[1:])
    log(f"  {name} per-pause state blob: {n_bytes / 1e6:.1f} MB per sequence; "
        f"to host {rd:.3f} ms ({n_bytes / rd / 1e6:.2f} GB/s), back "
        f"{wr:.3f} ms ({n_bytes / wr / 1e6:.2f} GB/s), median of {reps}; "
        f"round trip exact")


def phase_mamba2():
    log("phase 7: full-width mamba2-2.7b (64 layers, SSD state only, no paged "
        "layer), bf16")
    cfg, params, ctx = bf16_model("mamba2-2.7b", seed=3)
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
    ap.add_argument("--phases", default="1,2,3,4,5,6,7",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import flash_attention as fa
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

    # phases 4-7 are the main paths.  Each runs with every launch count and
    # every count of plain-version calls on CUDA tensors set to 0 just
    # before it, and read just after; the profiles and checks a phase runs
    # beside its serving runs are off the path (``off_path``)
    wrappers = {"paged": (pa, "paged_attention"), "flash": (fa, "flash_attention"),
                "ssd": (ssd, "ssd_scan")}
    plain_cuda_calls = dict.fromkeys(wrappers, 0)

    def counting(fn, key):
        def wrapped(x, *a, **kw):
            plain_cuda_calls[key] += int(x.is_cuda)
            return fn(x, *a, **kw)
        return wrapped

    for key, (mod, fn) in wrappers.items():
        setattr(mod, fn + "_plain", counting(getattr(mod, fn + "_plain"), key))
    main_paths = [(4, "granite-3-8b", phase_granite, ("paged", "flash")),
                  (5, "gemma3-4b", phase_gemma, ("paged", "flash")),
                  (6, "hymba-1.5b", phase_hymba, ("paged", "flash", "ssd")),
                  (7, "mamba2-2.7b", phase_mamba2, ("ssd",))]
    launches = dict.fromkeys(wrappers, 0)
    for num, name, run_path, used in main_paths:
        if num not in phases:
            continue
        for key, (mod, fn) in wrappers.items():
            getattr(mod, fn).launches = 0
            plain_cuda_calls[key] = 0
        t0 = time.perf_counter()
        run_path()
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
            dict(name="paged_attention", route="cuda",
                 source="src/repro_torch/csrc/paged_attention.cu",
                 replaces="src/repro/kernels/paged_attention.py:87",
                 launches=launches["paged"], **p),
            dict(name="flash_attention", route="cuda",
                 source="src/repro_torch/csrc/flash_attention_tc.cu",
                 replaces="src/repro/kernels/flash_attention.py:88",
                 launches=launches["flash"], **f),
            dict(name="ssd_scan", route="cuda",
                 source="src/repro_torch/csrc/ssd_scan.cu",
                 replaces="src/repro/kernels/ssd_scan.py:25",
                 launches=launches["ssd"], **d),
        ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
