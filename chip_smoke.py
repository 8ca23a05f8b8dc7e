#!/usr/bin/env python3
"""Drive the PyTorch port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases train    # the training path alone

Phases, each a failure of which exits non-zero:

1. kernels: build every kernel from the sources in this checkout (one
   nvcc per source, started together; sm_90a) and hold each against its
   plain PyTorch version on the card: paged attention (K4) at decode
   shapes, and the flash-attention forward, dq and dkv kernels (K1-K3)
   in float32 and bfloat16, d 64 and 128, causal and not, at seq 2048,
   a ragged seq 200 and sq != sk.  Time kernel, plain version, a
   PyTorch library yardstick and the card's bound at the main paths'
   shapes: the 8-slot decode step for K4, [96, 2048, 64] (BERT-base at
   batch 8, seq 2048) for K1-K3 in float32 and bfloat16, where K2 and K3
   must also give the same bits over two launches.  Bounds are those of
   each kernel's route (K1 float32 SIMT, K2 and K3 tensor cores); K2+K3
   is also given over the library's backward.  Every K2/K3 instance must
   hold HMMA instructions (cuobjdump's SASS of the built library, whose
   instruction counts are reported) and use no local memory (no
   spills); its registers, shared memory and blocks per SM are reported.
2. serve: full-width GPT-2-small (hidden 768, 12 layers, 12 heads, FFN
   3072, vocab 50257, 1024 positions, float32, weights from
   np.random.RandomState(0)) behind ContinuousScheduler and serve_http;
   16 concurrent greedy requests over HTTP.  The kernels' launch
   counters are set to 0 just before and read just after; every
   kernel of the path must have launched, the paged-attention kernel
   once per layer per forward.
3. parity: two of those requests through the port on device="cpu"
   with the same weights; per-step logits and greedy tokens against the
   card's.
4. profile: torch.profiler over 20 full-width decode steps; device time
   by kernel and the device's idle share.
5. train: full-width BERT-base (hidden 768, 12 layers, 12 heads, FFN
   3072, 2 classes) at batch 8, seq 2048, float32, inputs and labels
   from np.random.RandomState(0): compile with the default SGD, one
   warm-up train_step, fit over 4 batches, one eval_step.  The flash
   kernels' launch counters are set to 0 just before fit and read just
   after: K1, K2 and K3 must each have launched 12 times per step.
6. train_parity: the same BERT cut to 2 layers at batch 2, seq 2048 (the
   flash branch on both devices), two SGD steps on the card against the
   port on device="cpu" with the same weights and batches: losses and
   every weight after the steps.
7. train_profile: torch.profiler over 3 full-width train steps; device
   busy and idle time per step and K1, K2, K3 and K2+K3's shares.

`--phases` runs a subset (e.g. `--phases kernels` after editing a
kernel).  Every line but the last is one JSON object; the last is
{"ok": true, "device": {...}}.  Exits 2, printing no result, when
torch.cuda.is_available() is false.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

# GPT-2-small, build_gpt's own defaults
WIDTH = dict(hidden_size=768, num_layers=12, num_heads=12,
             intermediate_size=3072, vocab_size=50257, seq_length=1024)
SLOTS, PAGE, CHUNK = 8, 16, 8
N_REQUESTS, MAX_NEW = 16, 32
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores
H100_TF32_FLOPS = 495e12       # tensor cores, dense
H100_BF16_FLOPS = 989e12       # tensor cores, dense
# the route each flash kernel's products take: K1 float32 FMA on the SIMT
# path, K2 and K3 mma.sync on the tensor cores (float32 as three TF32
# passes, bfloat16 in one)
FLASH_ROUTE = {"K1": "simt", "K2": "tensor_cores", "K3": "tensor_cores"}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TOL_REASON = {
    "float32": "kernel and plain version both accumulate in float32; "
               "they differ only in summation order and exp, ~1e-6",
    "bfloat16": "held against the plain version run in float32 on the "
                "same bfloat16 values (the kernel accumulates in "
                "float32); 2e-2 covers the bfloat16 rounding of the "
                "output, 2^-9 of |out| <= ~4",
}
# BERT-base, build_bert's own defaults, at entry()'s batch and the
# reference's flash crossover
BERT = dict(hidden_size=768, num_layers=12, num_heads=12,
            intermediate_size=3072, num_classes=2)
TRAIN_BATCH, TRAIN_SEQ, FIT_BATCHES = 8, 2048, 4
FLASH_SHAPE = (TRAIN_BATCH * BERT["num_heads"], TRAIN_SEQ,
               BERT["hidden_size"] // BERT["num_heads"])
FLASH_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
FLASH_TOL_REASON = {
    "float32": "error over the output's scale max(1, max|plain|): kernel "
               "and plain version accumulate in float32 in other orders "
               "over up to 2048 keys; K2 and K3 form each product in "
               "three TF32 passes on the tensor cores (lo*lo, 2^-22 of "
               "it, dropped) and sum there",
    "bfloat16": "error over the output's scale, against the plain "
                "version run in float32 on the same bfloat16 values: the "
                "kernels round P and dS to bfloat16 before their products "
                "(as the TPU kernels do) and their outputs to bfloat16, "
                "2^-9 each",
}
# parity of the card's train steps with the port's CPU steps, TF32 off:
# float32 on both, sums in other orders (cuBLAS and the flash kernels
# against MKL and the plain versions)
PARITY_TOL = {"loss": 1e-4, "weights": 2e-5}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters: int = 30, warmup: int = 5) -> float:
    """Median device time of fn over `iters` runs (CUDA events), each
    after a write of `flush` that evicts the 50 MB L2 and keeps the
    device busy while the host enqueues the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def paged_case(torch, rng, *, b, s, h, d, page, width, dtype, dev):
    """Pools and tables with partial tail pages, one scratch row (slot
    0: seq_len 0, table all zeros) and CoW-shared blocks (rows 2 and 3
    map row 1's first blocks)."""
    nb = 1 + b * width
    pools = [torch.tensor(rng.randn(nb, page, h, d), dtype=torch.float32)
             for _ in range(2)]
    qh = torch.tensor(rng.randn(b, s, h, d), dtype=torch.float32)
    btab = rng.permutation(np.arange(1, nb))[:b * width].reshape(
        b, width).astype(np.int32)
    btab[0] = 0
    btab[2, :2] = btab[1, :2]
    btab[3, 0] = btab[1, 0]
    top = width * page - s
    slen = np.array([0] + [1 + rng.randint(top - 1) for _ in range(b - 1)],
                    np.int32)
    slen[1] = max(slen[1], 2 * page + 3)   # row 1 spans its shared blocks
    slen[2] = max(slen[2], 2 * page + 1)
    to = dict(device=dev)
    return (qh.to(dtype=dtype, **to), pools[0].to(dtype=dtype, **to),
            pools[1].to(dtype=dtype, **to),
            torch.tensor(btab, **to), torch.tensor(slen, **to))


def phase_kernels(torch, pk, card: str, dev, lib_path, build_s) -> dict:
    pk.load_library()
    rng = np.random.RandomState(0)
    cases, worst = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for s in (1, 8):
            for d in (64, 128):
                qh, kp, vp, bt, sl = paged_case(
                    torch, rng, b=6, s=s, h=12, d=d, page=PAGE, width=8,
                    dtype=dtype, dev=dev)
                scale = 1.0 / np.sqrt(d)
                got = pk.paged_attention(qh, kp, vp, bt, sl, scale)
                ref = pk.paged_attention_plain(
                    qh.float(), kp.float(), vp.float(), bt, sl, scale)
                same = pk.paged_attention_plain(qh, kp, vp, bt, sl, scale)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise RuntimeError(f"kernel output not finite: {dname} "
                                       f"s={s} d={d}")
                err = float((got.float() - ref).abs().max())
                err_same = float((got.float() - same.float()).abs().max())
                cases.append({"dtype": dname, "s": s, "d": d, "page": PAGE,
                              "max_abs_err": err,
                              "max_abs_err_vs_same_dtype_plain": err_same,
                              "tol": TOL[dname]})
                worst[dname] = max(worst.get(dname, 0.0), err)
                if err > TOL[dname]:
                    raise RuntimeError(
                        f"paged_attention kernel disagrees with its plain "
                        f"version: {dname} s={s} d={d}: max abs err {err} "
                        f"> {TOL[dname]}")

    # the main path's decode shape: 8 slots, 12 heads, d 64, f32,
    # page 16, rows at mixed positions up to 1024
    width = 1024 // PAGE
    nb = 1 + SLOTS * width
    h, d = 12, 64
    kp = torch.randn(nb, PAGE, h, d, device=dev)
    vp = torch.randn(nb, PAGE, h, d, device=dev)
    qh = torch.randn(SLOTS, 1, h, d, device=dev)
    btab = torch.tensor(rng.permutation(np.arange(1, nb)).reshape(
        SLOTS, width).astype(np.int32), device=dev)
    pos = rng.randint(1, 1024, SLOTS).astype(np.int32)
    pos[0] = 1023
    slen = torch.tensor(pos, device=dev)
    scale = 1.0 / np.sqrt(d)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def library():
        n = width * PAGE
        kv_k = kp[btab.long()].reshape(SLOTS, n, h, d).transpose(1, 2)
        kv_v = vp[btab.long()].reshape(SLOTS, n, h, d).transpose(1, 2)
        mask = (torch.arange(n, device=dev)[None, :]
                <= slen.long()[:, None])[:, None, None, :]
        return torch.nn.functional.scaled_dot_product_attention(
            qh.transpose(1, 2), kv_k, kv_v, attn_mask=mask, scale=scale)

    got = pk.paged_attention(qh, kp, vp, btab, slen, scale)
    ref = pk.paged_attention_plain(qh, kp, vp, btab, slen, scale)
    lib_out = library().transpose(1, 2)
    decode_err = float((got - ref).abs().max())
    if decode_err > TOL["float32"]:
        raise RuntimeError(f"decode shape: kernel vs plain {decode_err}")
    kernel_ms = time_ms(torch, lambda: pk.paged_attention(
        qh, kp, vp, btab, slen, scale), flush)
    plain_ms = time_ms(torch, lambda: pk.paged_attention_plain(
        qh, kp, vp, btab, slen, scale), flush)
    library_ms = time_ms(torch, library, flush)
    live_tokens = int((pos + 1).sum())
    kv_bytes = 2 * live_tokens * h * d * 4
    io_bytes = kv_bytes + 2 * qh.numel() * 4 + btab.numel() * 4 + SLOTS * 4
    flops = 4 * live_tokens * h * d
    bound_ms = max(io_bytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
    rec = {
        "phase": "kernels", "card": card, "build_s": round(build_s, 3),
        "library": lib_path.name, "cases": cases,
        "tolerance": TOL, "tolerance_reason": TOL_REASON,
        "decode_shape": {"slots": SLOTS, "heads": h, "d": d,
                         "dtype": "float32", "page": PAGE,
                         "positions": pos.tolist(),
                         "live_tokens": live_tokens,
                         "kv_bytes": kv_bytes},
        "decode_max_abs_err": decode_err,
        "library_max_abs_err": float((lib_out - ref).abs().max()),
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if io_bytes / H100_BYTES_PER_S
        >= flops / H100_F32_FLOPS else "operations",
    }
    emit(rec)
    rec["worst"] = worst
    return rec


def random_weights(ff) -> dict:
    """Weights from np.random.RandomState(0): normal(0, 0.02) for every
    entry, LayerNorm gamma 1 and beta 0, in graph order."""
    rng = np.random.RandomState(0)
    out = {}
    for op in ff.layers.topo_order():
        for spec in op.weight_specs[:op.num_trainable_weights()]:
            shape = spec.shape.logical_shape
            if spec.name == "gamma":
                arr = np.ones(shape, np.float32)
            elif spec.name == "beta":
                arr = np.zeros(shape, np.float32)
            else:
                arr = (rng.standard_normal(shape) * 0.02).astype(np.float32)
            out.setdefault(op.name, {})[spec.name] = arr
    return out


def build_model(device: str, weights=None):
    from flexflow_tpu_torch import CompMode, FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import build_gpt

    ff = FFModel(FFConfig(batch_size=SLOTS, device=device))
    build_gpt(ff, batch_size=SLOTS, **WIDTH)
    ff.compile(comp_mode=CompMode.INFERENCE)
    weights = weights if weights is not None else random_weights(ff)
    ff.set_weights(weights)
    return ff, weights


def make_prompts():
    rng = np.random.RandomState(1)
    lens = rng.randint(16, 257, N_REQUESTS)
    prefix = rng.randint(0, WIDTH["vocab_size"], 64).tolist()
    prompts = []
    for i, n in enumerate(lens):
        if i % 4 == 1:  # 4 of the 16 share a 64-token prefix
            n = max(int(n), 80)
            prompts.append(prefix + rng.randint(
                0, WIDTH["vocab_size"], n - 64).tolist())
        else:
            prompts.append(rng.randint(0, WIDTH["vocab_size"], n).tolist())
    return prompts


def timed(fn, log):
    def wrapper(*a):
        t0 = time.perf_counter()
        out = fn(*a)
        log.append(time.perf_counter() - t0)
        return out
    return wrapper


def post(url: str, payload: dict, timeout: float = 600.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def phase_serve(torch, pk, card: str, ff) -> dict:
    from flexflow_tpu_torch.serving import ContinuousScheduler, serve_http

    sched = ContinuousScheduler.from_trained(
        ff, batch_slots=SLOTS, page_size=PAGE, prefill_chunk=CHUNK,
        prefix_cache=True)
    step_s, prefill_s = [], []
    sched.model.step = timed(sched.model.step, step_s)
    sched.model.prefill_step = timed(sched.model.prefill_step, prefill_s)
    server = serve_http(generator=sched, port=0, block=False)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/v2/generate"
        prompts = make_prompts()
        results = [None] * len(prompts)
        errors = []

        def client(i):
            try:
                results[i] = post(url, {"prompt": prompts[i],
                                        "max_new_tokens": MAX_NEW})
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        torch.cuda.synchronize()
        pk.paged_attention.launches = 0
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = pk.paged_attention.launches
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"serve: requests failed: {errors}")
        stats = sched.stats()
    finally:
        server.shutdown()
        server.server_close()
        sched.close()
    generated = 0
    for p, r in zip(prompts, results):
        toks = r["tokens"][0]
        if len(toks) != len(p) + MAX_NEW or toks[:len(p)] != p:
            raise RuntimeError(
                f"serve: completion of length {len(toks)} for a prompt "
                f"of {len(p)} (+{MAX_NEW})")
        if not all(0 <= t < WIDTH["vocab_size"] for t in toks):
            raise RuntimeError("serve: token id out of the vocabulary")
        generated += len(toks) - len(p)
    forwards = stats["steps"] + stats["prefill_steps"] * CHUNK
    want = WIDTH["num_layers"] * forwards
    if launches != want or launches == 0:
        raise RuntimeError(
            f"serve: paged_attention launched {launches} times, expected "
            f"{WIDTH['num_layers']} x ({stats['steps']} decode steps + "
            f"{stats['prefill_steps']} x {CHUNK} prefill positions) = "
            f"{want}")
    if stats["paged_kernel"]["formulation"] != "cuda":
        raise RuntimeError("serve: the engine did not read through the "
                           "CUDA kernel")
    rec = {
        "phase": "serve", "card": card, "requests": len(prompts),
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "generated_tokens": generated, "wall_s": wall,
        "tokens_per_s": generated / wall,
        "decode_steps": stats["steps"],
        "prefill_steps": stats["prefill_steps"],
        "mean_decode_step_ms": 1e3 * float(np.mean(step_s)),
        "mean_prefill_step_ms": 1e3 * float(np.mean(prefill_s)),
        "prefix_hits": stats["prefix_cache"]["hits"],
        "prefix_hit_tokens": stats["prefix_cache"]["hit_tokens"],
        "kv_blocks_read": stats["paged_kernel"]["blocks_read"],
        "kv_bytes_read": stats["paged_kernel"]["bytes_read"],
        "dense_blocks_equiv": stats["paged_kernel"]["dense_blocks_equiv"],
        "paged_attention_launches": launches,
        "launches_per_forward": launches / forwards,
        "kv_pool_blocks": sched.model.num_blocks,
    }
    emit(rec)
    rec["prompts"] = prompts
    return rec


def run_recorded(ff, prompt):
    """One request alone through a fresh engine on ff's device; returns
    the completion and {position: slot-0 logits} of every step that
    sampled a token."""
    from flexflow_tpu_torch.serving import ContinuousScheduler

    sched = ContinuousScheduler.from_trained(
        ff, batch_slots=SLOTS, page_size=PAGE, prefill_chunk=CHUNK,
        prefix_cache=True)
    rows = {}
    step = sched.model.step

    def recording(tokens, seq_lens, btab):
        logits = step(tokens, seq_lens, btab)
        if seq_lens[0] >= len(prompt) - 1:
            rows[int(seq_lens[0])] = logits[0].copy()
        return logits

    sched.model.step = recording
    try:
        out = sched.generate(prompt, 8, timeout=900)
    finally:
        sched.close()
    return out, rows


def phase_parity(torch, card: str, ff_cuda, weights, prompts) -> dict:
    short = sorted((p for p in prompts if len(p) <= 64), key=len)[:2]
    if len(short) < 2:
        short = [p[:64] for p in prompts[:2]]
    ff_cpu, _ = build_model("cpu", weights)
    worst, checked, steps = 0.0, 0, 0
    for prompt in short:
        out_g, rows_g = run_recorded(ff_cuda, prompt)
        out_c, rows_c = run_recorded(ff_cpu, prompt)
        for pos in sorted(rows_g):
            g, c = rows_g[pos], rows_c[pos]
            if not (np.isfinite(g).all() and np.isfinite(c).all()):
                raise RuntimeError(f"parity: non-finite logits at {pos}")
            worst = max(worst, float(np.abs(g - c).max()))
            steps += 1
            i = pos - len(prompt) + 1  # index of the sampled token
            top2 = np.sort(c)[-2:]
            gap = float(top2[1] - top2[0])
            if out_g[len(prompt) + i] != out_c[len(prompt) + i]:
                if gap > 1e-2:
                    raise RuntimeError(
                        f"parity: greedy tokens differ at position {pos} "
                        f"with a top-2 gap of {gap}")
                break  # the sequences diverge past a near tie
            checked += 1
        if worst > 2e-3:
            raise RuntimeError(f"parity: logits differ by {worst} > 2e-3")
    rec = {"phase": "parity", "card": card, "requests": len(short),
           "prompt_lens": [len(p) for p in short], "steps": steps,
           "tokens_checked": checked, "max_abs_logit_diff": worst,
           "tol": 2e-3, "allow_tf32": False}
    emit(rec)
    return rec


def phase_profile(torch, card: str, ff, steps: int = 20) -> dict:
    """Where a full-width decode step's time goes: torch.profiler over
    `steps` decode steps of 8 rows at mixed positions up to 1024, with
    device time summed by kernel name and the device's idle share of
    the host's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.serving import PagedKVDecodeModel

    width = WIDTH["seq_length"] // PAGE
    model = PagedKVDecodeModel(ff, batch_slots=SLOTS, page_size=PAGE,
                               num_blocks=1 + SLOTS * width)
    rng = np.random.RandomState(2)
    btab = rng.permutation(np.arange(1, model.num_blocks)).reshape(
        SLOTS, width).astype(np.int32)
    pos = rng.randint(1, WIDTH["seq_length"] - steps - 10, SLOTS)
    tokens = rng.randint(0, WIDTH["vocab_size"], SLOTS).astype(np.int32)
    for k in range(5):
        model.step(tokens, (pos + k).astype(np.int32), btab)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(steps):
            model.step(tokens, (pos + 5 + k).astype(np.int32), btab)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, count = {}, {}
    for evt in prof.events():
        if "cuda" not in str(evt.device_type).lower():
            continue
        us = evt.time_range.elapsed_us()
        by_name[evt.name] = by_name.get(evt.name, 0.0) + us
        count[evt.name] = count.get(evt.name, 0) + 1
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    rec = {
        "phase": "profile", "card": card, "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if by_name else None,
        "device_events_per_step": sum(count.values()) / steps,
        "top_kernels": [{"name": n[:80], "ms_per_step": us / 1e3 / steps,
                         "launches_per_step": count[n] / steps}
                        for n, us in top],
    }
    emit(rec)
    return rec

def _scaled_err(got, ref) -> tuple:
    """(max |got - ref|, that over the output's scale max(1, max|ref|))"""
    diff = float((got.float() - ref.float()).abs().max())
    return diff, diff / max(1.0, float(ref.float().abs().max()))


def flash_case(torch, fa, gen, *, bh, sq, sk, d, causal, dtype, dev):
    """K1, K2 and K3 on one case against the plain versions run in
    float32 on the same values; {kernel: (abs err, scaled err)}."""
    q, k, v = (torch.randn(bh, n, d, generator=gen, device=dev).to(dtype)
               for n in (sq, sk, sk))
    dout = torch.randn(bh, sq, d, generator=gen, device=dev).to(dtype)
    scale = 1.0 / np.sqrt(d)
    out, lse = fa.flash_fwd(q, k, v, scale, causal)
    delta = fa.flash_delta(out, dout)
    dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, causal)
    f = [t.float() for t in (q, k, v, dout)]
    r_out, r_lse = fa.flash_fwd_plain(f[0], f[1], f[2], scale, causal)
    r_dq, r_dk, r_dv = fa.flash_bwd_plain(f[0], f[1], f[2], r_out, r_lse,
                                          f[3], scale, causal)
    torch.cuda.synchronize()
    got = {"K1": [(out, r_out), (lse, r_lse)], "K2": [(dq, r_dq)],
           "K3": [(dk, r_dk), (dv, r_dv)]}
    res = {}
    for kern, pairs in got.items():
        for g, _ in pairs:
            if not torch.isfinite(g).all():
                raise RuntimeError(f"{kern} output not finite: {dtype} "
                                   f"bh={bh} sq={sq} sk={sk} d={d} "
                                   f"causal={causal}")
        errs = [_scaled_err(g, r) for g, r in pairs]
        res[kern] = (max(e[0] for e in errs), max(e[1] for e in errs))
    return res


def flash_bounds(bh, sq, sk, d, dtype="float32") -> dict:
    """Least time of each kernel on the card at one shape (non-causal):
    the larger of its bytes (each input read once, each output written
    once) over HBM and its operations over the peak of its route.  On
    the float32 SIMT route that is 67 TFLOP/s (bfloat16 is widened to
    float32 there); on the tensor cores a float32 product takes three
    TF32 passes (3 x flops at 495 TFLOP/s) and a bfloat16 product one
    (989 TFLOP/s).  Both operation bounds are reported; `bound_ms` and
    `bound_by` are those of the kernel's route (FLASH_ROUTE)."""
    itemsize = 4 if dtype == "float32" else 2
    pairs = bh * sq * sk * d
    qb, kb = bh * sq * d * itemsize, bh * sk * d * itemsize
    rows = bh * sq * 4
    work = {
        # QK^T and PV
        "K1": (4 * pairs, 2 * qb + 2 * kb + rows),
        # QK^T, dO V^T and dS K; reads q, k, v, dO, lse, delta; writes dq
        "K2": (6 * pairs, 3 * qb + 2 * kb + 2 * rows),
        # QK^T, dO V^T, P^T dO and dS^T Q; writes dk and dv
        "K3": (8 * pairs, 2 * qb + 4 * kb + 2 * rows),
    }
    tc_name, tc_s_per_flop = (
        ("3xTF32 tensor cores", 3 / H100_TF32_FLOPS) if dtype == "float32"
        else ("bfloat16 tensor cores", 1 / H100_BF16_FLOPS))
    out = {}
    for kern, (flops, nbytes) in work.items():
        t_bytes = nbytes / H100_BYTES_PER_S
        t_ops = {"simt": flops / H100_F32_FLOPS,
                 "tensor_cores": flops * tc_s_per_flop}
        route = FLASH_ROUTE[kern]
        ops_name = {"simt": "float32 SIMT",
                    "tensor_cores": tc_name}[route]
        out[kern] = {"flops": flops, "bytes": nbytes, "route": route,
                     "simt_bound_ms": max(t_ops["simt"], t_bytes) * 1e3,
                     "tc_bound_ms": max(t_ops["tensor_cores"],
                                        t_bytes) * 1e3,
                     "bound_ms": max(t_ops[route], t_bytes) * 1e3,
                     "bound_by": f"operations, {ops_name}"
                     if t_ops[route] >= t_bytes else "bytes"}
    return out


def sass_counts(lib_path) -> dict:
    """Instructions in each flash kernel instance of the built library,
    from cuobjdump's SASS (see count_sass)."""
    from flexflow_tpu_torch.ops.kernels import _build

    tool = str(Path(_build.find_nvcc()).with_name("cuobjdump"))
    return count_sass(subprocess.run(
        [tool, "--dump-sass", str(lib_path)], capture_output=True,
        text=True, timeout=300, check=True).stdout)


def count_sass(sass: str) -> dict:
    """{"K2 float32 d64": {"hmma": tensor-core instructions,
    "instructions": all instructions}, ...} per flash kernel instance in
    a SASS listing."""
    names = {"flash_fwd_kernel": "K1", "flash_bwd_dq_kernel": "K2",
             "flash_bwd_dkv_kernel": "K3"}
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_fwd_kernel|flash_bwd_dq_kernel|"
                          r"flash_bwd_dkv_kernel)I(f|13__nv_bfloat16)Li(\d+)E",
                          line)
            current = None if m is None else (
                f"{names[m.group(1)]} "
                f"{'float32' if m.group(2) == 'f' else 'bfloat16'} "
                f"d{m.group(3)}")
            if current:
                counts[current] = {"hmma": 0, "instructions": 0}
        elif current and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[current]["instructions"] += 1
            counts[current]["hmma"] += "HMMA" in line
    return counts


def flash_main_shape(torch, fa, gen, dtype, dev, flush) -> dict:
    """K1-K3 at the main path's shape (BERT-base at batch 8, seq 2048,
    non-causal) in `dtype`: agreement with the plain versions run in
    float32 on the same values, K2 and K3 bit-identical over two
    launches, and the times of the kernels, the plain versions (float32
    only) and the library."""
    bh, s, d = FLASH_SHAPE
    dname = str(dtype).removeprefix("torch.")
    q, k, v, dout = (torch.randn(bh, s, d, generator=gen, device=dev).to(
        dtype) for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    out, lse = fa.flash_fwd(q, k, v, scale, False)
    delta = fa.flash_delta(out, dout)
    dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, False)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, False)
    dq2 = fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, False)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, False)
    deterministic = {"K2": torch.equal(dq, dq2),
                     "K3": torch.equal(dk, dk2) and torch.equal(dv, dv2)}
    if not all(deterministic.values()):
        raise RuntimeError(f"main shape {dname}: two launches on the same "
                           f"inputs differ: {deterministic}")
    del dq2, dk2, dv2
    f = [t.float() for t in (q, k, v, dout)]
    r_out, r_lse = fa.flash_fwd_plain(f[0], f[1], f[2], scale, False)
    r_dq, r_dk, r_dv = fa.flash_bwd_plain(f[0], f[1], f[2], r_out, r_lse,
                                          f[3], scale, False)
    err = {"K1": max(_scaled_err(out, r_out)[1], _scaled_err(lse, r_lse)[1]),
           "K2": _scaled_err(dq, r_dq)[1],
           "K3": max(_scaled_err(dk, r_dk)[1], _scaled_err(dv, r_dv)[1])}
    del f, r_out, r_lse, r_dq, r_dk, r_dv, dq, dk, dv
    for kern, e in err.items():
        if e > FLASH_TOL[dname]:
            raise RuntimeError(f"main shape {dname}: {kern} vs plain {e}")
    b, h = TRAIN_BATCH, BERT["num_heads"]
    q4, k4, v4 = (t.view(b, h, s, d).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(q4, k4, v4, scale=scale)
    dout4 = dout.view(b, h, s, d)
    ms = {
        "K1": time_ms(torch, lambda: fa.flash_fwd(q, k, v, scale, False),
                      flush),
        "K2": time_ms(torch, lambda: fa.flash_bwd_dq(
            q, k, v, dout, lse, delta, scale, False), flush),
        "K3": time_ms(torch, lambda: fa.flash_bwd_dkv(
            q, k, v, dout, lse, delta, scale, False), flush),
    }
    plain_ms = None
    if dtype == torch.float32:
        plain_fwd = time_ms(torch, lambda: fa.flash_fwd_plain(
            q, k, v, scale, False), flush, iters=10, warmup=2)
        plain_bwd = time_ms(torch, lambda: fa.flash_bwd_plain(
            q, k, v, out, lse, dout, scale, False), flush, iters=10,
            warmup=2)
        plain_ms = {"K1": plain_fwd, "K2": plain_bwd, "K3": plain_bwd}
    lib_fwd = time_ms(torch, lambda: sdpa(q4, k4, v4, scale=scale), flush)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (q4, k4, v4), dout4, retain_graph=True), flush)
    bounds = flash_bounds(bh, s, s, d, dname)
    return {
        "err_over_scale": err, "deterministic": deterministic,
        "kernel_ms": ms, "plain_ms": plain_ms,
        "library_ms": {"K1": lib_fwd, "K2": lib_bwd, "K3": lib_bwd},
        "bounds": bounds,
        "tflops": {kern: bounds[kern]["flops"] / ms[kern] / 1e9
                   for kern in ms},
        "share_of_bound": {kern: bounds[kern]["bound_ms"] / ms[kern]
                           for kern in ms},
        "share_of_tc_bound": {kern: bounds[kern]["tc_bound_ms"] / ms[kern]
                              for kern in ms},
        "K2+K3_ms": ms["K2"] + ms["K3"],
        "K2+K3_over_library_bwd": (ms["K2"] + ms["K3"]) / lib_bwd,
    }


def phase_flash_kernels(torch, fa, card: str, dev, lib_path) -> dict:
    fa.load_library()
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [dict(bh=4, sq=2048, sk=2048), dict(bh=4, sq=200, sk=200)]
    cases, worst = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        runs = [dict(sh, d=d, causal=c) for sh in shapes for d in (64, 128)
                for c in (False, True)]
        runs.append(dict(bh=4, sq=300, sk=1000, d=64, causal=False))
        for r in runs:
            res = flash_case(torch, fa, gen, dtype=dtype, dev=dev, **r)
            cases.append(dict(r, dtype=dname, **{
                f"{kern}_max_abs_err": e[0] for kern, e in res.items()},
                **{f"{kern}_err_over_scale": e[1]
                   for kern, e in res.items()}))
            for kern, (abs_err, scaled) in res.items():
                w = worst.setdefault(kern, {}).setdefault(dname, [0.0, 0.0])
                w[0], w[1] = max(w[0], abs_err), max(w[1], scaled)
                if scaled > FLASH_TOL[dname]:
                    raise RuntimeError(
                        f"{kern} disagrees with its plain version: {dname} "
                        f"{r}: error {scaled} of the output's scale > "
                        f"{FLASH_TOL[dname]}")

    bh, s, d = FLASH_SHAPE
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    main = {str(dt).removeprefix("torch."): flash_main_shape(
        torch, fa, gen, dt, dev, flush)
        for dt in (torch.float32, torch.bfloat16)}
    # what the card gives each K2/K3 instance, and proof that its products
    # run on the tensor cores
    resources = {
        f"{kid} {str(dt).removeprefix('torch.')} d{d}":
            fa.bwd_resources(kern, d, dt)
        for kid, kern in (("K2", "dq"), ("K3", "dkv"))
        for dt in (torch.float32, torch.bfloat16) for d in (64, 128)}
    sass = sass_counts(lib_path)
    faults = [f"{n} uses {r['local_bytes']} bytes of local memory (spills)"
              for n, r in resources.items() if r["local_bytes"]]
    faults += [f"{n} has no HMMA instruction" for n in resources
               if not sass.get(n, {}).get("hmma")]

    rec = {
        "phase": "kernels", "kernels": "K1-K3", "card": card,
        "library": lib_path.name, "cases": cases,
        "tolerance": FLASH_TOL, "tolerance_reason": FLASH_TOL_REASON,
        "k2_k3_resources": resources, "sass": sass,
        "main_shape": {"bh": bh, "sq": s, "sk": s, "d": d,
                       "causal": False},
        "main": main,
        "plain_note": "K2 and K3 share one plain backward (dq, dk, dv)",
        "library_note": "scaled_dot_product_attention forward; its "
                        "autograd backward (dq, dk, dv) for K2 and K3",
    }
    emit(rec)
    if faults:
        raise RuntimeError("K2/K3: " + "; ".join(faults))
    rec["worst"] = worst
    return rec


def build_bert_model(device: str, num_layers: int, batch: int, seed: int = 0,
                     metrics=("accuracy", "sparse_categorical_crossentropy")):
    """Full-width BERT at seq 2048, compiled for training with the
    default SGD; weights drawn by compile from `seed`."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import build_bert

    ff = FFModel(FFConfig(batch_size=batch, device=device, seed=seed))
    build_bert(ff, batch_size=batch, seq_length=TRAIN_SEQ,
               **dict(BERT, num_layers=num_layers))
    ff.compile(metrics=metrics, seed=seed)
    return ff


def bert_data(n: int, seed: int):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, TRAIN_SEQ, BERT["hidden_size"])).astype(
        np.float32)
    y = rng.randint(0, BERT["num_classes"], (n, 1)).astype(np.int32)
    return x, y


def flash_launches(fa) -> dict:
    return {"K1": fa.flash_fwd.launches, "K2": fa.flash_bwd_dq.launches,
            "K3": fa.flash_bwd_dkv.launches}


def reset_flash_launches(fa) -> None:
    fa.flash_fwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def phase_train(torch, fa, card: str):
    """Full-width BERT-base at batch 8, seq 2048 through compile,
    train_step, fit and eval_step on the card."""
    t0 = time.perf_counter()
    ff = build_bert_model("cuda", BERT["num_layers"], TRAIN_BATCH)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    n = TRAIN_BATCH * (1 + FIT_BATCHES)
    x, y = bert_data(n, seed=0)
    t0 = time.perf_counter()
    warm = ff.train_step({"input": x[:TRAIN_BATCH]}, y[:TRAIN_BATCH])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    losses = []
    step = ff.train_step

    def recording(inputs, labels):
        m = step(inputs, labels)
        losses.append(m["loss"])
        return m

    ff.train_step = recording
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_flash_launches(fa)
    t0 = time.perf_counter()
    hist = ff.fit(x[TRAIN_BATCH:], y[TRAIN_BATCH:], batch_size=TRAIN_BATCH,
                  epochs=1, verbose=False)
    wall = time.perf_counter() - t0  # fit synchronizes at the epoch's end
    launches = flash_launches(fa)
    del ff.train_step
    peak = torch.cuda.max_memory_allocated()
    reset_flash_launches(fa)
    ev = ff.eval_step({"input": x[:TRAIN_BATCH]}, y[:TRAIN_BATCH])
    logits = ff.forward({"input": x[:TRAIN_BATCH]})
    eval_launches = flash_launches(fa)
    want = BERT["num_layers"] * FIT_BATCHES
    if launches != {"K1": want, "K2": want, "K3": want}:
        raise RuntimeError(
            f"train: flash launches {launches} over {FIT_BATCHES} steps, "
            f"expected {BERT['num_layers']} per step each ({want})")
    if eval_launches != {"K1": 2 * BERT["num_layers"], "K2": 0, "K3": 0}:
        raise RuntimeError(f"train: eval_step + forward launched "
                           f"{eval_launches}")
    loss_vals = [float(warm["loss"])] + [float(v) for v in losses]
    pm = hist[0]
    if not (np.isfinite(loss_vals).all() and np.isfinite(float(ev["loss"]))
            and tuple(logits.shape) == (TRAIN_BATCH, BERT["num_classes"])
            and torch.isfinite(logits).all()):
        raise RuntimeError(f"train: non-finite or misshapen results: "
                           f"losses {loss_vals}, eval {ev}, logits "
                           f"{tuple(logits.shape)}")
    if pm.train_all != TRAIN_BATCH * FIT_BATCHES:
        raise RuntimeError(f"train: fit scored {pm.train_all} samples")
    rec = {
        "phase": "train", "card": card,
        "model": dict(BERT, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      dtype="float32", optimizer="SGD(lr=0.01, wd=1e-4)"),
        "compile_s": compile_s, "warmup_step_s": warm_s,
        "fit_steps": FIT_BATCHES, "fit_wall_s": wall,
        "step_ms": wall / FIT_BATCHES * 1e3,
        "samples_per_s": TRAIN_BATCH * FIT_BATCHES / wall,
        "losses": loss_vals, "eval_loss": float(ev["loss"]),
        "fit_accuracy": pm.accuracy,
        "fit_mean_loss": pm.sparse_cce_loss / pm.train_all,
        "flash_launches": launches,
        "flash_launches_per_step": {k: v / FIT_BATCHES
                                    for k, v in launches.items()},
        "peak_memory_gb": peak / 1e9,
    }
    emit(rec)
    return ff, x[:TRAIN_BATCH], y[:TRAIN_BATCH], rec


def phase_train_parity(torch, fa, card: str) -> dict:
    """Two SGD steps of full-width BERT, 2 layers, batch 2, seq 2048 on
    the card and on the CPU from the same weights and batches."""
    layers, batch, steps = 2, 2, 2
    ff_g = build_bert_model("cuda", layers, batch, seed=1)
    ff_c = build_bert_model("cpu", layers, batch, seed=1)
    ff_c.set_weights(ff_g.get_weights())
    x, y = bert_data(batch * steps, seed=1)
    reset_flash_launches(fa)
    losses = {"cuda": [], "cpu": []}
    for i in range(steps):
        sl = slice(batch * i, batch * (i + 1))
        for dev, ff in (("cuda", ff_g), ("cpu", ff_c)):
            losses[dev].append(float(ff.train_step({"input": x[sl]},
                                                   y[sl])["loss"]))
    launches = flash_launches(fa)
    if launches != {"K1": layers * steps, "K2": layers * steps,
                    "K3": layers * steps}:
        raise RuntimeError(f"train_parity: card launches {launches}")
    loss_diff = max(abs(a - b) for a, b in zip(losses["cuda"],
                                               losses["cpu"]))
    wg, wc = ff_g.get_weights(), ff_c.get_weights()
    weight_diff, worst_w = 0.0, None
    for op, entries in wc.items():
        for k, v in entries.items():
            dlt = float(np.abs(wg[op][k] - v).max())
            if dlt > weight_diff:
                weight_diff, worst_w = dlt, f"{op}.{k}"
    if not all(np.isfinite(losses["cuda"] + losses["cpu"])):
        raise RuntimeError(f"train_parity: non-finite losses {losses}")
    if loss_diff > PARITY_TOL["loss"] or weight_diff > PARITY_TOL["weights"]:
        raise RuntimeError(
            f"train_parity: card vs CPU loss diff {loss_diff}, weight diff "
            f"{weight_diff} ({worst_w}) over {PARITY_TOL}")
    rec = {"phase": "train_parity", "card": card, "layers": layers,
           "batch": batch, "seq": TRAIN_SEQ, "steps": steps,
           "losses": losses, "max_loss_diff": loss_diff,
           "max_weight_diff": weight_diff, "worst_weight": worst_w,
           "tolerance": PARITY_TOL, "allow_tf32": False,
           "flash_launches_on_card": launches}
    emit(rec)
    return rec


def phase_train_profile(torch, fa, card: str, ff, x, y,
                        steps: int = 3) -> dict:
    """torch.profiler over `steps` full-width train steps: device time by
    kernel, K1-K3's shares, busy and idle time per step."""
    from torch.profiler import ProfilerActivity, profile

    ff.train_step({"input": x}, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ff.train_step({"input": x}, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, count = {}, {}
    for evt in prof.events():
        if "cuda" not in str(evt.device_type).lower():
            continue
        us = evt.time_range.elapsed_us()
        by_name[evt.name] = by_name.get(evt.name, 0.0) + us
        count[evt.name] = count.get(evt.name, 0) + 1
    busy_us = sum(by_name.values())
    if not by_name:
        raise RuntimeError("train_profile: the profiler saw no device time")
    flash = {}
    for kern, tag in (("K1", "flash_fwd_kernel"),
                      ("K2", "flash_bwd_dq_kernel"),
                      ("K3", "flash_bwd_dkv_kernel")):
        us = sum(v for n, v in by_name.items() if tag in n)
        n = sum(c for nm, c in count.items() if tag in nm)
        flash[kern] = {"ms_per_step": us / 1e3 / steps,
                       "share_of_busy": us / busy_us,
                       "launches_per_step": n / steps}
    flash["K2+K3"] = {
        key: flash["K2"][key] + flash["K3"][key]
        for key in ("ms_per_step", "share_of_busy")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    rec = {
        "phase": "train_profile", "card": card, "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_ms_per_step": (wall_ms - busy_us / 1e3) / steps,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "device_events_per_step": sum(count.values()) / steps,
        "flash": flash,
        "top_kernels": [{"name": n[:80], "ms_per_step": us / 1e3 / steps,
                         "launches_per_step": count[n] / steps}
                        for n, us in top],
    }
    emit(rec)
    return rec


ALL_PHASES = ("kernels,serve,parity,profile,train,train_parity,"
              "train_profile")


def kernel_line(kern: dict, flash: dict, serve, train, card: str) -> dict:
    """The JSON line of every kernel: launches on the main paths,
    agreement with the plain versions and the times of this run."""
    rows = [{
        "name": "paged_attention",
        "id": "K4",
        "route": "cuda",
        "source": "flexflow_tpu_torch/csrc/paged_attention.cu",
        "replaces": "flexflow_tpu/ops/pallas/paged_attention.py:99",
        "launches": serve["paged_attention_launches"] if serve else 0,
        "launches_per_decode_step": (serve["launches_per_forward"]
                                     if serve else None),
        "max_abs_err": max(kern["worst"].values()),
        "max_abs_err_by_dtype": kern["worst"],
        "tolerance": TOL,
        "ms": kern["kernel_ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
        "card": card,
    }]
    names = {"K1": ("flash_fwd", 78), "K2": ("flash_bwd_dq", 217),
             "K3": ("flash_bwd_dkv", 265)}
    f32, bf16 = flash["main"]["float32"], flash["main"]["bfloat16"]
    for kid, (name, line) in names.items():
        worst = flash["worst"][kid]
        bound = f32["bounds"][kid]
        rows.append({
            "name": name,
            "id": kid,
            "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"flexflow_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": train["flash_launches"][kid] if train else 0,
            "launches_per_train_step": (
                train["flash_launches_per_step"][kid] if train else None),
            "max_abs_err": max(w[0] for w in worst.values()),
            "max_err_over_scale_by_dtype": {
                dt: w[1] for dt, w in worst.items()},
            "tolerance": FLASH_TOL,
            "ms": f32["kernel_ms"][kid],
            "plain_ms": f32["plain_ms"][kid],
            "bound_ms": bound["bound_ms"],
            # "operations" or "bytes"; the route beside it
            "bound_by": bound["bound_by"].split(",")[0],
            "bound_by_route": bound["bound_by"],
            "share_of_bound": f32["share_of_bound"][kid],
            "simt_bound_ms": bound["simt_bound_ms"],
            "tc_bound_ms": bound["tc_bound_ms"],
            "library_ms": f32["library_ms"][kid],
            "bfloat16_ms": bf16["kernel_ms"][kid],
            "bfloat16_bound_ms": bf16["bounds"][kid]["bound_ms"],
            "bfloat16_library_ms": bf16["library_ms"][kid],
            "card": card,
        })
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=ALL_PHASES,
                    help="comma-separated subset of the phases")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    unknown = phases - set(ALL_PHASES.split(","))
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script drives the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flexflow_tpu_torch.ops.kernels import _build
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import paged_attention as pk

    card = card_line()
    emit({"card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    paged_lib, flash_lib = _build.build(pk.SOURCE, fa.SOURCE)
    build_s = time.perf_counter() - t0
    emit({"build": [paged_lib.name, flash_lib.name], "build_s": build_s,
          "note": "one nvcc per source, started together"})
    dev = torch.device("cuda")
    kern = flash = serve = train = None
    if "kernels" in phases:
        kern = phase_kernels(torch, pk, card, dev, paged_lib, build_s)
        flash = phase_flash_kernels(torch, fa, card, dev, flash_lib)
    if phases & {"serve", "parity", "profile"}:
        ff, weights = build_model("cuda")
        if "serve" in phases:
            serve = phase_serve(torch, pk, card, ff)
        if "parity" in phases:
            prompts = serve["prompts"] if serve else make_prompts()
            phase_parity(torch, card, ff, weights, prompts)
        if "profile" in phases:
            phase_profile(torch, card, ff)
        del ff
    if phases & {"train", "train_profile"}:
        ff, xb, yb, train = phase_train(torch, fa, card)
        if "train_profile" in phases:
            phase_train_profile(torch, fa, card, ff, xb, yb)
        del ff
        torch.cuda.empty_cache()
    if "train_parity" in phases:
        phase_train_parity(torch, fa, card)
    if kern is not None:
        emit(kernel_line(kern, flash, serve, train, card))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
