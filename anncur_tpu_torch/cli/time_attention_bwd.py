"""Kernels D and C and the whole attention backward, for this checkout's
``csrc/attention_bwd.cu`` and for other builds of it, side by side.

    python anncur_tpu_torch/cli/time_attention_bwd.py [--source FILE.cu ...] [--wide]

Each ``--source`` is a variant of ``csrc/attention_bwd.cu`` with the same C
entries (it may include this checkout's headers by copying them beside
it); it is compiled with ``cuda_build.NVCC_FLAGS`` into
``anncur_tpu_torch/build/``. For this checkout's library and then each
variant, the wrappers of ``ops/attention.py`` are pointed at the library,
and at the train step's negatives (b=63 g=s=255 nh=12 hd=64 bf16, every key
valid), the bi-encoder towers' hard negatives (b=252 g=s=128) and 64 pairs
of ragged key lengths it times kernel D, then C, then the whole backward
through the autograd (``chip_smoke.py``'s ``time_ms``: L2 flushed, a
device spin, median of 30) and holds dQ, dK, dV against the plain
autograd (max error over max). Then SDPA's backward at the first two
shapes. With ``--wide`` the shapes are instead the wide route's (head dims
above 256) at ``chip_smoke.WIDE_SHAPE``, b=64 g=s=255 nh=4 with random key
lengths: hd 272, 384, 512 and 768, bf16 and f32 (10 timed calls each), with
SDPA's backward at each. With a ``--source`` the libraries run in turns:
the variants, this checkout twice, the variants again in reverse (one
variant, the parent: parent, change, change, parent). Prints ptxas' serialisation
warnings of each build (C7514, C7515, C7520), then one JSON line per library
and shape with the card. Needs a CUDA card; compare designs only within one
run.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, _HERE)

# (b, g, s, every key valid)
SHAPES = ((63, 255, 255, True), (252, 128, 128, True), (64, 255, 255, False))
WIDE = tuple((hd, dtype) for dtype in (torch.bfloat16, torch.float32) for hd in (272, 384, 512, 768))


def _cases(smoke, dev, wide):
    """(label, (q, k, v, key_valid, dout), timed calls, every key valid) of
    each shape, made from one seed."""
    gen = torch.Generator(device=dev).manual_seed(7)
    if not wide:
        for b, g, s, all_valid in SHAPES:
            q, k, v, key_valid, _, _, dout = smoke.bwd_inputs(gen, b, g, s, 12, 64, dev, all_valid)
            yield f"b={b} g={g} s={s} hd=64 bf16", (q, k, v, key_valid, dout), 30, all_valid
        return
    b, g, s, nh = smoke.WIDE_SHAPE
    for hd, dtype in WIDE:
        q, k, v, key_valid, lengths = smoke.attention_inputs(gen, b, g, s, nh, hd, dev, dtype=dtype)
        rows = (torch.arange(g, device=dev)[None, :] < lengths[:, None]).expand(b, g)
        dout = (torch.randn(q.shape, generator=gen, device=dev) * rows[:, :, None, None]).to(dtype)
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        yield f"b={b} g={g} s={s} nh={nh} hd={hd} {name}", (q, k, v, key_valid, dout), 10, False


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(_HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[], help="a variant of csrc/attention_bwd.cu")
    ap.add_argument("--wide", action="store_true", help="the wide route's shapes (hd 272-768, bf16 and f32)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_attention_bwd: needs a CUDA card")
    from anncur_tpu_torch.ops import cuda_build
    from anncur_tpu_torch.ops.attention import (
        attention, attention_bwd_dkv, attention_bwd_dq, attention_bwd_plain, attention_fwd,
    )

    smoke = _chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    cuda_build.build()
    libs = {"this checkout": (cuda_build.load("attention_bwd"), cuda_build.library_path("attention_bwd") + ".log")}
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    builds = {}
    for i, src in enumerate(args.source):
        out = os.path.join(cuda_build.BUILD_DIR, f"variant{i}-" + os.path.basename(src).replace(".cu", ".so"))
        builds[src] = (out, subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, src],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for src, (out, proc) in builds.items():
        log, _ = proc.communicate()
        with open(out + ".log", "w") as fout:
            fout.write(log)
        if proc.returncode:
            raise SystemExit(f"time_attention_bwd: {src} does not build:\n{log}")
        libs[src] = (ctypes.CDLL(os.path.abspath(out)), out + ".log")
    for name, (_, log_path) in libs.items():
        with open(log_path) as fin:
            for line in fin:
                if any(code in line for code in ("C7514", "C7515", "C7520")):
                    print(f"{name}: {line.strip()}", flush=True)
    order = list(libs)
    if args.source:  # in turns: variants, this checkout twice, variants reversed
        order = order[1:] + [order[0], order[0]] + order[:0:-1]

    dev = torch.device("cuda", 0)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    try:
        for name in order:
            cuda_build._LOADED["attention_bwd"] = libs[name][0]
            for label, (q, k, v, key_valid, dout), reps, all_valid in _cases(smoke, dev, args.wide):
                out, lse = attention_fwd(q, k, v, key_valid, with_lse=True)
                dq, delta = attention_bwd_dq(q, k, v, key_valid, dout, out, lse)
                dk, dv = attention_bwd_dkv(q, k, v, key_valid, dout, lse, delta)
                want = attention_bwd_plain(q, k, v, key_valid, dout)
                errs = [float((a.float() - w.float()).abs().max() / w.float().abs().max())
                        for a, w in zip((dq, dk, dv), want)]
                d_ms = smoke.time_ms(lambda: attention_bwd_dq(q, k, v, key_valid, dout, out, lse), reps, flush)
                c_ms = smoke.time_ms(lambda: attention_bwd_dkv(q, k, v, key_valid, dout, lse, delta), reps, flush)
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                whole_ms = smoke.time_grad_ms(attention(*leaves, key_valid), leaves, dout, reps, flush)
                print(json.dumps({"library": name, "card": card, "shape": label, "every_key_valid": all_valid,
                                  "d_ms": d_ms, "c_ms": c_ms, "whole_backward_ms": whole_ms,
                                  "rel_err_dq_dk_dv": errs}), flush=True)
                del out, lse, dq, dk, dv, delta, want, leaves
    finally:
        cuda_build._LOADED["attention_bwd"] = libs["this checkout"][0]
    for label, (q, k, v, key_valid, dout), reps, all_valid in _cases(smoke, dev, args.wide):
        if not args.wide and not all_valid:
            continue
        mask = None if all_valid else key_valid[:, None, None, :]
        leaves = [t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask)
        sdpa_ms = smoke.time_grad_ms(lib_out, leaves, dout.transpose(1, 2), reps, flush)
        print(json.dumps({"library": "SDPA backward", "card": card, "shape": label,
                          "whole_backward_ms": sdpa_ms}), flush=True)


if __name__ == "__main__":
    main()
