#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. device   the card's name and power limit (nvidia-smi); no card -> exit 1
  2. build    nvcc builds vct_tpu_torch/csrc into the package's _build/
  3. kernels  each CUDA kernel against its plain PyTorch version on the card,
              at the MSVD widths in bfloat16 (seeded inputs, several idx and
              l_view windows, both window poisons)
  4. server   configs/msvd.json with a synthetic 30522-entry vocab and seeded
              random weights saved as a reference-keyed .pth; the port's HTTP
              server on port 0 with max_batch 32 answers concurrent
              /v1/caption requests (some shorter than 12 frames, so the memory
              mask is used); the served tokens are held against the port's
              module path on the card
  5. b128     greedy_generate_fused at B=128 (fused_layers_step +
              fused_norm_generator_argmax) against the module path
  6. timings  kernel vs plain times, ms per token of both decode paths at
              B=1, 32 and 128, captions/s of the server phase

Launch counts are set to 0 just before phases 4 and 5 and read just after
each: the server must have launched the whole-step kernel, the B=128 decode
the other two. The line before the last is a JSON object with one entry per
kernel; the last line is {"ok": true, "device": {...}}, printed only when
every phase passed. Any failure exits 1 before it.
"""

from __future__ import annotations

import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
from http.client import HTTPConnection
from pathlib import Path

import numpy as np
import torch

SEED = 666
MAX_BATCH = 32
N_REQUESTS = 48
# bfloat16 keeps 8 significant bits. Kernel and plain version round at the
# same points but sum in other orders, so a value near a rounding boundary
# may land one unit in the last place (2**-6 at magnitudes 2..4 after a
# LayerNorm) apart, and such a unit travels on through later layers.
BF16_ATOL = 0.125          # max abs difference: 8 such units
BF16_MEAN_ATOL = 2e-3      # mean abs difference: almost every value agrees
NEAR_TIE_SAME = 1e-2       # kernel vs plain version: same rounding points
# The module path rounds every product, and its logits, to bfloat16: logits
# of magnitude 4..8 carry a unit of 2**-5, and the hidden state differs from
# the kernels' fp32-statistics schedule by a few such units.
NEAR_TIE_MODULE = 0.125
SOURCE = "vct_tpu_torch/csrc/decode_step.cu"
REPLACES = {
    "fused_whole_step": "vct_tpu/ops/pallas_decode.py:581",
    "fused_layers_step": "vct_tpu/ops/pallas_decode.py:516",
    "fused_norm_generator_argmax": "vct_tpu/ops/pallas_decode.py:811",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def synthetic_vocab(path: Path, size: int = 30522) -> None:
    """BERT's special ids ([PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102,
    [MASK]=103), filler words elsewhere."""
    special = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}
    words = [special.get(i, f"[unused{i}]" if i < 100 else f"w{i}") for i in range(size)]
    path.write_text("\n".join(words) + "\n")


def cuda_time(fn, iters: int = 20) -> float:
    """ms per call by CUDA events, after a warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def step_inputs(fw, b, idx, tm, gen):
    """Seeded decode-step inputs at the model's widths: caches filled below
    idx, zeros from idx on, a memory bias that masks the tail of odd rows."""
    stacked = fw["stacked"]
    nl, e, dt, dev = stacked["wqkv"].shape[0], stacked["wqkv"].shape[1], \
        stacked["wqkv"].dtype, stacked["wqkv"].device
    g = torch.Generator(device="cpu").manual_seed(gen)
    rnd = lambda *s: torch.randn(s, generator=g).to(dev, dt)  # noqa: E731
    kc, vc = rnd(nl, 32, b, e), rnd(nl, 32, b, e)
    kc[:, idx:] = 0
    vc[:, idx:] = 0
    mem_bias = torch.zeros((b, tm), device=dev)
    mem_bias[1::2, -4:] = -1e30
    return {"x": rnd(b, e), "kc": kc, "vc": vc, "ck": rnd(nl, tm, b, e),
            "cv": rnd(nl, tm, b, e), "mem_bias": mem_bias}


def compare_float(name, got, want, means):
    """Max abs difference of two bf16 results; their mean abs difference is
    appended to ``means``."""
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"{name}: non-finite values")
    d = (got.float() - want.float()).abs()
    mx, mean = float(d.max()), float(d.mean())
    means.append(mean)
    if mx > BF16_ATOL or mean > BF16_MEAN_ATOL:
        fail(f"{name}: max abs diff {mx} (limit {BF16_ATOL}), mean {mean} "
             f"(limit {BF16_MEAN_ATOL})")
    return mx


def token_err(name, got, want, logits, bound):
    """Tokens must agree except where the plain logits' top-2 gap is under
    ``bound``; returns the largest logit shortfall of a differing token."""
    bad = (got != want).nonzero().flatten().tolist()
    top = torch.topk(logits.float(), 2, dim=-1).values
    gaps = (top[:, 0] - top[:, 1])
    err = 0.0
    for r in bad:
        gap = float(gaps[r])
        if gap >= bound:
            fail(f"{name}: row {r} token {int(got[r])} vs {int(want[r])}, top-2 gap "
                 f"{gap} >= {bound}")
        err = max(err, float(logits[r, want[r]] - logits[r, got[r]]))
    if bad:
        say(f"  {name}: {len(bad)}/{len(got)} tokens differ, all near-ties")
    return err


def plain_logits(dk, x, fw):
    return dk._ln(x, fw["norm_s"], fw["norm_b"]) @ fw["wg"].float() + fw["bg"]


def check_kernels(fw, heads, tm):
    from vct_tpu_torch.ops import decode_kernels as dk

    errs = {k: 0.0 for k in REPLACES}
    means = []
    # fused_whole_step at B=1 and B=32, windows below the full 32 rows
    for b, cases in ((1, ((0, 8), (7, 8), (17, 24))), (32, ((3, 8), (12, 16), (29, 32)))):
        for idx, l_view in cases:
            a = step_inputs(fw, b, idx, tm, gen=b * 100 + idx)
            k1, v1 = a["kc"].clone(), a["vc"].clone()
            k2, v2 = a["kc"].clone(), a["vc"].clone()
            tok, _, _ = dk.fused_whole_step(a["x"], k1, v1, a["ck"], a["cv"], a["mem_bias"],
                                            fw, idx, heads=heads, l_view=l_view)
            x_ref = dk._stack_reference(a["x"], k2, v2, a["ck"], a["cv"], a["mem_bias"],
                                        fw["stacked"], idx, heads, l_view)
            tok_ref = dk.fused_norm_generator_argmax_reference(
                x_ref, fw["norm_s"], fw["norm_b"], fw["wg"], fw["bg"])
            torch.cuda.synchronize()
            name = f"fused_whole_step B={b} idx={idx} l_view={l_view}"
            errs["fused_whole_step"] = max(
                errs["fused_whole_step"],
                compare_float(name + " k rows", k1[:, idx], k2[:, idx], means),
                compare_float(name + " v rows", v1[:, idx], v2[:, idx], means),
                token_err(name, tok, tok_ref, plain_logits(dk, x_ref, fw), NEAR_TIE_SAME))
            if int(tok.max()) >= fw["vocab"]:
                fail(f"{name}: a padded vocab column won")
            say(f"  ok {name}")
    # fused_layers_step at B=128
    for idx, l_view in ((5, 8), (20, 24), (31, 32)):
        a = step_inputs(fw, 128, idx, tm, gen=1000 + idx)
        k1, v1 = a["kc"].clone(), a["vc"].clone()
        k2, v2 = a["kc"].clone(), a["vc"].clone()
        x_k, _, _ = dk.fused_layers_step(a["x"], k1, v1, a["ck"], a["cv"], a["mem_bias"],
                                         fw["stacked"], idx, heads=heads, l_view=l_view)
        x_r, _, _ = dk.fused_layers_step_reference(a["x"], k2, v2, a["ck"], a["cv"],
                                                   a["mem_bias"], fw["stacked"], idx,
                                                   heads=heads, l_view=l_view)
        torch.cuda.synchronize()
        name = f"fused_layers_step B=128 idx={idx} l_view={l_view}"
        errs["fused_layers_step"] = max(
            errs["fused_layers_step"], compare_float(name + " x_out", x_k, x_r, means),
            compare_float(name + " k rows", k1[:, idx], k2[:, idx], means),
            compare_float(name + " v rows", v1[:, idx], v2[:, idx], means))
        say(f"  ok {name}")
    # fused_norm_generator_argmax at B=128 on decoder-like activations
    a = step_inputs(fw, 128, 9, tm, gen=2000)
    x, _, _ = dk.fused_layers_step_reference(a["x"], a["kc"], a["vc"], a["ck"], a["cv"],
                                             a["mem_bias"], fw["stacked"], 9,
                                             heads=heads, l_view=16)
    tok = dk.fused_norm_generator_argmax(x, fw["norm_s"], fw["norm_b"], fw["wg"], fw["bg"])
    tok_ref = dk.fused_norm_generator_argmax_reference(x, fw["norm_s"], fw["norm_b"],
                                                       fw["wg"], fw["bg"])
    torch.cuda.synchronize()
    errs["fused_norm_generator_argmax"] = token_err(
        "fused_norm_generator_argmax B=128", tok, tok_ref, plain_logits(dk, x, fw),
        NEAR_TIE_SAME)
    say("  ok fused_norm_generator_argmax B=128")
    # the window poisons
    a = step_inputs(fw, 32, 8, tm, gen=3000)
    tok, _, _ = dk.fused_whole_step(a["x"], a["kc"], a["vc"], a["ck"], a["cv"],
                                    a["mem_bias"], fw, 8, heads=heads, l_view=8)
    x, _, _ = dk.fused_layers_step(a["x"], a["kc"], a["vc"], a["ck"], a["cv"],
                                   a["mem_bias"], fw["stacked"], 16, heads=heads, l_view=16)
    torch.cuda.synchronize()
    if not bool((tok == -1).all()) or not bool(torch.isnan(x.float()).all()):
        fail("window poisons did not fire")
    say("  ok window poisons (tokens -1, activations NaN)")
    say(f"  max abs differences {errs}, worst mean abs difference {max(means)}")
    return errs


def time_kernels(fw, heads, tm):
    from vct_tpu_torch.ops import decode_kernels as dk

    out = {}
    a = step_inputs(fw, 32, 12, tm, gen=4000)
    args = (a["x"], a["kc"], a["vc"], a["ck"], a["cv"], a["mem_bias"])
    out["fused_whole_step"] = (
        cuda_time(lambda: dk.fused_whole_step(*args, fw, 12, heads=heads, l_view=16)),
        cuda_time(lambda: dk.fused_whole_step_reference(*args, fw, 12, heads=heads,
                                                        l_view=16)))
    a = step_inputs(fw, 128, 12, tm, gen=4001)
    args = (a["x"], a["kc"], a["vc"], a["ck"], a["cv"], a["mem_bias"], fw["stacked"])
    out["fused_layers_step"] = (
        cuda_time(lambda: dk.fused_layers_step(*args, 12, heads=heads, l_view=16)),
        cuda_time(lambda: dk.fused_layers_step_reference(*args, 12, heads=heads,
                                                         l_view=16)))
    gargs = (a["x"], fw["norm_s"], fw["norm_b"], fw["wg"], fw["bg"])
    out["fused_norm_generator_argmax"] = (
        cuda_time(lambda: dk.fused_norm_generator_argmax(*gargs)),
        cuda_time(lambda: dk.fused_norm_generator_argmax_reference(*gargs)))
    return out


# ---------------------------------------------------------------------------
# phases 4-5: the server and the B=128 decode against the module path
# ---------------------------------------------------------------------------


def check_against_module(model, feats, masks, got, what):
    from vct_tpu_torch.decode import first_mismatch_gaps, greedy_generate

    want, _ = greedy_generate(model, feats, masks, max_len=got.shape[1],
                              start_id=101, end_id=102)
    mism = first_mismatch_gaps(model, feats, masks, got, want)
    for row, pos, gap in mism:
        if gap >= NEAR_TIE_MODULE:
            fail(f"{what}: row {row} parts from the module path at position {pos} "
                 f"with top-2 gap {gap} >= {NEAR_TIE_MODULE}")
    say(f"  {what}: {len(got) - len(mism)}/{len(got)} rows equal to the module path, "
        f"{len(mism)} part at near-ties (max gap "
        f"{max([g for _, _, g in mism], default=0.0):.4g})")


def request_body(i, rng):
    t = (12, 12, 8, 5, 20, 3)[i % 6]  # < 12 frames pads the memory; 20 subsamples
    arr = rng.standard_normal((t, 512)).astype(np.float32)
    buf = io.BytesIO()
    if i % 4 == 3:
        np.savez(buf, CLIP4Clip=arr)
    else:
        np.save(buf, arr)
    return buf.getvalue()


def run_server(cfg, ckpt, model):
    from vct_tpu_torch.ops import decode_kernels as dk
    from vct_tpu_torch.serve import serve

    srv = serve(cfg, str(ckpt), device=torch.device("cuda", 0), host="127.0.0.1", port=0,
                max_batch=MAX_BATCH, batch_timeout_ms=20.0, log=say)
    records = []
    decode = srv.service.decode_fn

    def recording_decode(feats, masks):
        tokens, attn = decode(feats, masks)
        records.append((feats, masks, tokens))
        return tokens, attn

    srv.service.decode_fn = recording_decode
    plain_on_cuda = []
    originals = {}
    for name in ("fused_whole_step_reference", "fused_layers_step_reference",
                 "fused_norm_generator_argmax_reference"):
        fn = getattr(dk, name)
        originals[name] = fn

        def spy(x, *a, _fn=fn, _name=name, **k):
            if x.is_cuda:
                plain_on_cuda.append(_name)
            return _fn(x, *a, **k)

        setattr(dk, name, spy)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    rng = np.random.default_rng(SEED)
    bodies = [request_body(i, rng) for i in range(N_REQUESTS)]
    results = [None] * N_REQUESTS

    def post(i):
        conn = HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/v1/caption", body=bodies[i])
        resp = conn.getresponse()
        results[i] = (resp.status, json.loads(resp.read()))
        conn.close()

    try:
        conn = HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        if health.get("status") != "ok":
            fail(f"/healthz: {health}")
        for fn in dk.WRAPPERS:
            fn.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(N_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        elapsed = time.perf_counter() - t0
        launches = dk.fused_whole_step.launches
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.close()
        thread.join(timeout=30)
        for name, fn in originals.items():
            setattr(dk, name, fn)
    if any(t.is_alive() for t in threads):
        fail("server: clients still waiting")
    bad = [r for r in results if r is None or r[0] != 200
           or not isinstance(r[1].get("caption"), str)]
    if bad:
        fail(f"server: {len(bad)} requests failed, e.g. {bad[0]}")
    if launches == 0:
        fail("server: fused_whole_step was never launched")
    if plain_on_cuda:
        fail(f"server: plain versions ran on CUDA tensors: {sorted(set(plain_on_cuda))}")
    say(f"  {N_REQUESTS} requests answered 200 in {len(records)} batches, "
        f"fused_whole_step launches {launches}")
    for feats, masks, tokens in records:
        check_against_module(model, feats, masks, tokens, "served batch")
    return launches, N_REQUESTS / elapsed, elapsed


def run_b128(model, fw):
    """The two-kernel path (B > 64) through greedy_generate_fused ->
    launches of its two kernels, counted from 0."""
    from vct_tpu_torch.decode_fast import greedy_generate_fused
    from vct_tpu_torch.ops import decode_kernels as dk

    dev = fw["wg"].device
    g = torch.Generator().manual_seed(SEED + 1)
    feats = [torch.randn((128, 12, 512), generator=g).to(dev)]
    masks = torch.zeros((128, 12), dtype=torch.bool)
    masks[::3, 7:] = True
    masks = [masks.to(dev)]
    for fn in dk.WRAPPERS:
        fn.launches = 0
    got, _ = greedy_generate_fused(model, feats, masks, max_len=30, start_id=101,
                                   end_id=102, fw=fw)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in dk.WRAPPERS}
    for name in ("fused_layers_step", "fused_norm_generator_argmax"):
        if launches[name] == 0:
            fail(f"b128: {name} was never launched")
    if launches["fused_whole_step"]:
        fail("b128: the whole-step kernel ran above B=64")
    say(f"  launches {launches}")
    check_against_module(model, feats, masks, got, "B=128 decode")
    return launches


def time_decode(model, fw, card):
    """ms per token of the kernel path and the module path, 29 tokens with
    the encoder included, host clock around synchronised runs."""
    from vct_tpu_torch.decode import greedy_generate
    from vct_tpu_torch.decode_fast import greedy_generate_fused

    dev = fw["wg"].device
    report = {}
    for b in (1, 32, 128):
        g = torch.Generator().manual_seed(SEED + b)
        feats = [torch.randn((b, 12, 512), generator=g).to(dev)]
        masks = [torch.zeros((b, 12), dtype=torch.bool, device=dev)]
        for label, fn in (
                ("kernel", lambda: greedy_generate_fused(
                    model, feats, masks, max_len=30, start_id=101, end_id=-1, fw=fw)),
                ("plain", lambda: greedy_generate(
                    model, feats, masks, max_len=30, start_id=101, end_id=-1))):
            fn()
            torch.cuda.synchronize()
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1000 / reps / 29
            report[f"ms_per_token_{label}_b{b}"] = ms
            path = "kernel path" if label == "kernel" else "plain path (module)"
            say(f"  B={b} {path}: {ms:.3f} ms/token [{card}]")
    return report


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    repo = Path(__file__).resolve().parent
    if not (repo / "vct_tpu_torch" / "csrc").is_dir():
        fail(f"{repo} holds no vct_tpu_torch package: run from a checkout")
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    say(card)
    kind = torch.cuda.get_device_name(0)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} device(s)")

    from vct_tpu_torch.cli.common import load_config, make_trainer_pieces
    from vct_tpu_torch.decode_fast import extract_fast_weights
    from vct_tpu_torch.ops._build import load_library

    t0 = time.perf_counter()
    load_library()
    say(f"build: {load_library.build_seconds:.1f} s nvcc, "
        f"{time.perf_counter() - t0:.1f} s with loading")
    for line in load_library.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say("  ptxas: " + line.strip())

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        vocab = work / "vocab.txt"
        synthetic_vocab(vocab)
        cfg = load_config(str(repo / "configs" / "msvd.json"))
        cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, vocab_path=str(vocab)))
        model, _ = make_trainer_pieces(cfg, torch.device("cpu"), seed=SEED)
        ckpt = work / "msvd_seeded.pth"
        torch.save(model.state_dict(), ckpt)
        n_params = sum(t.numel() for t in model.state_dict().values())
        model = model.to(torch.device("cuda", 0)).to_compute_dtype()
        fw = extract_fast_weights(model)
        fw["vocab"] = model.config.vocab_size
        heads, tm = fw["heads"], cfg.tpu.max_frames + 1
        say(f"model: configs/msvd.json, {n_params} parameters and buffers, vocab "
            f"{model.config.vocab_size} (padded {fw['wg'].shape[1]}), {cfg.tpu.dtype}")

        say("phase kernels: CUDA kernels against their plain versions (bf16)")
        errs = check_kernels(fw, heads, tm)
        say(f"phase server: {N_REQUESTS} concurrent /v1/caption, max_batch {MAX_BATCH}")
        whole_launches, cps, elapsed = run_server(cfg, ckpt, model)
        say(f"  server: {cps:.1f} captions/s ({N_REQUESTS} in {elapsed:.2f} s) [{card}]")
        say("phase b128: greedy_generate_fused at B=128 (two-kernel path)")
        launches = run_b128(model, fw)
        launches["fused_whole_step"] = whole_launches
        say(f"phase timings [{card}]")
        kernel_times = time_kernels(fw, heads, tm)
        for name, (ms, plain) in kernel_times.items():
            say(f"  {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms [{card}]")
        report = {"server_captions_per_s": cps, **time_decode(model, fw, card)}

    say(json.dumps(report))
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": kernel_times[name][0], "plain_ms": kernel_times[name][1]}
        for name in REPLACES]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
