"""Kernels A and B of one checkout, timed at ``chip_smoke.py``'s shapes.

    python anncur_tpu_torch/cli/time_kernels.py [--root DIR]

Imports ``anncur_tpu_torch`` from ``--root`` (default: this checkout), so
that another commit's kernels (a ``git archive`` of it) run on the same
card in the same call; run it for each root in turns (parent, change,
change, parent). Times them with this checkout's ``chip_smoke.py`` (the
same yardstick for every root): kernel A with ``time_attention`` at the
hd-64 layers (the build's b=2048 g=s=256 and the train layer's b=64
g=s=255, random key lengths; the bi-encoder towers' b=252 and b=256
g=s=128, every key valid) beside SDPA, kernel A's wide route (hd 272, 384,
512 and 768, bf16 and f32, at ``chip_smoke.WIDE_SHAPE``) with its error
against the plain attention, SDPA beside it, and kernel B with ``time_mips``
(its score stage and select apart, beside ``matmul`` + ``topk``) at
``MIPS_SHAPES`` (exclusions where a shape has them), the hard-negative
mine, the TF-IDF mine's width and ZeShEL-military's shape, on seeded
normal inputs. A shape the checkout's wrapper rejects is reported as
such. Prints one JSON line per kernel and shape with the card and the
root. Each ``--source`` is a variant of ``csrc/attention.cu`` or
``csrc/mips_topk.cu`` (named so, with the headers it includes beside it,
the same C entries): it is built with ``cuda_build.NVCC_FLAGS``, and its
kernel is timed on the same inputs in turns with this checkout's (the
variants, this checkout twice, the variants reversed: with one variant,
the parent, parent / change / change / parent), with kernel B's
top-k scores also held against f64 products (``f64_accuracy``) at the
mine and ZeShEL-military. Needs a CUDA card; compare designs only within
one run.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (b, g, s, every key valid)
ATTENTION_SHAPES = ((2048, 256, 256, False), (64, 255, 255, False), (252, 128, 128, True), (256, 128, 128, True))
# kernel A's wide route: (hd, dtype) at chip_smoke.WIDE_SHAPE
WIDE_SHAPES = tuple((hd, dtype) for dtype in (torch.bfloat16, torch.float32) for hd in (272, 384, 512, 768))
# (q, d, n, k): the TF-IDF mine's width (cli/compute_tfidf_hard_negs.py,
# dense here) and ZeShEL-military's 13,063 mentions over 104,520 entities
MIPS_LOSING_SHAPES = ((400, 16620, 10000, 64), (13063, 768, 104520, 64))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(_HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _variants(sources):
    """(name, library kind, loaded library) of each variant source, built
    side by side; raises with the compiler's output when one fails."""
    import ctypes

    from anncur_tpu_torch.ops import cuda_build

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    builds = []
    for i, src in enumerate(sources):
        kind = os.path.basename(src)[: -len(".cu")]
        if kind not in ("attention", "mips_topk"):
            raise SystemExit(f"time_kernels: {src} is not a variant of attention.cu or mips_topk.cu")
        out = os.path.join(cuda_build.BUILD_DIR, f"variant{i}-{kind}.so")
        proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        builds.append((src, kind, out, proc))
    found = []
    for src, kind, out, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"time_kernels: {src} does not build:\n{log}")
        print(json.dumps({"variant": src, "ptxas_serialised": [x for x in log.splitlines() if "(C75" in x]}), flush=True)
        found.append((src, kind, ctypes.CDLL(os.path.abspath(out))))
    return found


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_HERE, help="checkout whose anncur_tpu_torch is timed")
    ap.add_argument("--source", action="append", default=[], help="a variant of csrc/attention.cu or mips_topk.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA card")
    smoke = _chip_smoke()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from anncur_tpu_torch.ops import cuda_build, mips_kernel
    from anncur_tpu_torch.ops.mips import mips_topk
    from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    cuda_build.build(["attention", "mips_topk"])
    libs = [("this checkout", kind, cuda_build.load(kind)) for kind in ("attention", "mips_topk")]
    libs += _variants(args.source)

    def each(kind):
        """Each library of ``kind``, loaded in turn as the wrappers' own: with
        variants, in turns (the variants, this checkout twice, the variants
        reversed)."""
        mine = [(name, lib) for name, k, lib in libs if k == kind]
        order = mine[1:] + [mine[0], mine[0]] + mine[:0:-1] if len(mine) > 1 else mine
        try:
            for name, lib in order:
                cuda_build._LOADED[kind] = lib
                mips_kernel._INIT_DEVICES.clear()  # the attributes of this library's kernels
                yield name
        finally:
            cuda_build._LOADED[kind] = libs[0 if kind == "attention" else 1][2]
            mips_kernel._INIT_DEVICES.clear()

    dev = torch.device("cuda", 0)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for b, g, s, all_valid in ATTENTION_SHAPES:
        q, k, v, valid, lengths = smoke.attention_inputs(gen, b, g, s, 12, 64, dev, all_valid)
        for name in each("attention"):
            rec = smoke.time_attention(q, k, v, valid, lengths, 20, flush, all_valid)
            print(json.dumps({"kernel": "A", "root": root, "library": name, "card": card, **rec}), flush=True)
        del q, k, v, valid
    from anncur_tpu_torch.ops.attention import attention, attention_plain

    b, g, s, nh = smoke.WIDE_SHAPE
    for hd, dtype in WIDE_SHAPES:
        q, k, v, valid, _ = smoke.attention_inputs(gen, b, g, s, nh, hd, dev, dtype=dtype)
        shape = f"b={b} g={g} s={s} nh={nh} hd={hd} {str(dtype)[6:]}, random key lengths"
        want = attention_plain(q, k, v, valid).float()
        for name in each("attention"):
            err = float((attention(q, k, v, valid).float() - want).abs().max())
            ms = smoke.time_ms(lambda: attention(q, k, v, valid), 10, flush)
            print(json.dumps({"kernel": "A", "root": root, "library": name, "card": card, "ms": ms,
                              "max_abs_err_vs_plain": err, "shape": shape}), flush=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_ms = smoke.time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=valid[:, None, None, :]), 10, flush)
        print(json.dumps({"kernel": "SDPA", "card": card, "ms": sdpa_ms, "shape": shape}), flush=True)
        del q, k, v, valid, want, qt, kt, vt
    gen = torch.Generator(device=dev).manual_seed(2)
    shapes = [*smoke.MIPS_SHAPES, (*smoke.MINE_SHAPE[:3], smoke.MINE_SHAPE[2], smoke.MINE_SHAPE[3], 0)]
    shapes += [(q, d, n, n, k, 0) for q, d, n, k in MIPS_LOSING_SHAPES]
    for q, d, n, n_valid, k, n_ex in shapes:
        queries, items = smoke.mips_inputs(gen, dev, q, d, n, n_valid)
        # as chip_smoke.py: a growth round's exclusions are each query's best ids
        exclude = mips_topk(queries, items, n_ex, n_valid)[1] if n_ex else None
        for name in each("mips_topk"):
            rec = {"kernel": "B", "root": root, "library": name, "card": card}
            try:
                rec.update(smoke.time_mips(mips_topk_fused, mips_topk, queries, items, k, n_valid, flush, exclude))
                if d == 768 and q >= 1024 and hasattr(smoke, "f64_accuracy"):
                    rec["f64"] = smoke.f64_accuracy(queries, items, k, f"{name} q={q} d={d} n={n}")
            except (ValueError, TypeError) as exc:  # a checkout that predates a shape's argument
                rec.update(shape=f"q={q} d={d} n={n} n_valid={n_valid} k={k} S={n_ex} f32", rejected=str(exc))
            except SystemExit as exc:  # f64_accuracy past its limit: reported, not fatal to a comparison
                rec.update(failed=str(exc))
            print(json.dumps(rec), flush=True)
        del queries, items, exclude
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
