"""Where the generic attention kernels' time goes: ablated builds, timed.

    python -m distributed_crawler_tpu_torch.ops.generic_ablation [--seed N]
        [--against OTHER.cu]

Each variant is `csrc/flash_attention.cu` (the ``mma_sync`` and ``simt``
routes) with one piece of work taken out by a text substitution; an
ablated variant's output is wrong on purpose.  Every variant is built by
nvcc (all started together) into the git-ignored `_build/ablation/`, and
timed by CUDA-graph replay, all in one process on one card, at six
shapes: E5-small's attention at bucket 512 (batch 256, 12 heads of 32, each
row's length in the top half of the bucket) in bf16 and in f32,
XLM-R-base's (12 heads of 64) at bucket 512 in bf16, TinyBERT-4L-312D's
(12 heads of 26 through the fused QKV view: 4-byte copies) at bucket 512
in bf16, and Whisper-small's encoder ([8, 1500, 12, 64], no mask) in bf16
and in f32.  It prints one JSON line per shape: ms
per variant, each variant's largest error against the plain version, and
the card's name and power limit.  Needs a CUDA card and nvcc; torch is
imported only when it runs.

With ``--against``, it builds OTHER.cu (another version of the source with
the same C entry point, such as an earlier commit's) beside this one and
times both, unmodified, at the shapes of PERF.md's kernel table, summed per
shape over its buckets (batch 256, buckets 32-512, each row's length in the
top half of its bucket: E5-small in bf16 and f32, XLM-R-base, E5-large;
Whisper-small's [B, 1500, 12, 64] at B = 1/2/4/8), in the order other,
this, this, other in one process, and prints one JSON line per shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Dict, List, Tuple

from .. import kernels

SOURCE = kernels.CSRC_DIR / kernels.SOURCES["flash_attention"]
OUT_DIR = kernels.BUILD_DIR / "ablation"

VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    # The producer computes every address but copies nothing.
    "no_copy": [("    cp_async<kUnit>(dst, live ? row + cb : any, "
                 "live ? n : 0);", "    (void)dst;\n    (void)n;")],
    # The consumers only wait and release each stage.
    "consumers_idle": [
        ("      if (k0 >= 0 && (flags & 1)) {\n        fence_proxy_async();",
         "      if (false) {\n        fence_proxy_async();"),
        ("      if (k0 >= 0 && (flags & 1)) {\n        float s[4 * kNB];",
         "      if (false) {\n        float s[4 * kNB];"),
        ("        if (k0 >= 0) {  // some warpgroup computes it",
         "        if (false) {  // some warpgroup computes it")],
    # bf16 at head dims up to 32: a ring of 8 stages instead of 4.
    "stages_8": [("  static constexpr int kStages = Dp <= 64 ? 4 : "
                  "(Dp == 128 ? 3 : 2);",
                  "  static constexpr int kStages = Dp <= 32 ? 8 : "
                  "(Dp <= 64 ? 4 : (Dp == 128 ? 3 : 2));")],
    # bf16: no async-proxy fence before the consumers' wgmma.
    "no_fence": [("        fence_proxy_async();\n        // S = Q K^T",
                  "        // S = Q K^T")],
    # f32: operands passed to the tensor cores unsplit (lo = 0).
    "no_split": [("  hi = tf32_rna(x);\n"
                  "  lo = tf32_rna(x - __uint_as_float(hi));",
                  "  hi = __float_as_uint(x);\n  lo = 0u;")],
    # f32: one TF32 product per product instead of three.
    "one_product": [("  mma_tf32(d, a_lo, b0_hi, b1_hi);\n"
                     "  mma_tf32(d, a_hi, b0_lo, b1_lo);\n", "")],
}
# PERF.md's kernel table: (name, heads, head dim, dtype, [(batch, L)],
# masked).
TABLE_SHAPES = (
    ("e5_small", 12, 32, "bfloat16", [(256, l) for l in (32, 64, 128, 256,
                                                         512)], True),
    ("xlmr_base", 12, 64, "bfloat16", [(256, l) for l in (32, 64, 128, 256,
                                                          512)], True),
    ("whisper", 12, 64, "bfloat16", [(b, 1500) for b in (1, 2, 4, 8)],
     False),
    ("e5_large", 16, 64, "bfloat16", [(256, l) for l in (32, 64, 128, 256,
                                                         512)], True),
    ("e5_small", 12, 32, "float32", [(256, l) for l in (32, 64, 128, 256,
                                                        512)], True),
)
SHAPES = (("e5_small", 256, 512, 12, 32, "bfloat16", True),
          ("xlmr_base", 256, 512, 12, 64, "bfloat16", True),
          ("tinybert", 256, 512, 12, 26, "bfloat16", True),
          ("whisper", 8, 1500, 12, 64, "bfloat16", False),
          ("e5_small", 256, 512, 12, 32, "float32", True),
          ("whisper", 8, 1500, 12, 64, "float32", False))


def variant_source(name: str, source: str) -> str:
    """The kernel's source with the variant's substitutions; raises when
    one no longer matches the source."""
    for old, new in VARIANTS[name]:
        if old not in source:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        source = source.replace(old, new)
    return source


def build_all(names, sources=None) -> Dict[str, ctypes.CDLL]:
    """One library per name: the variant of this source, or the text
    ``sources[name]`` as it is."""
    from .attention import SIGNATURES

    nvcc = kernels.nvcc_path()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    source = SOURCE.read_text()
    procs = {}
    for name in names:
        src = OUT_DIR / f"generic_{name}.cu"
        src.write_text((sources or {}).get(name)
                       or variant_source(name, source))
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-o",
               str(OUT_DIR / f"generic_{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT_DIR / f"generic_{name}.so"))
        for fn, (argtypes, restype) in SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def _inputs(torch, gen, device, b, l, h, d, dtype, masked):
    """q, k, v as views of one [b, l, 3, h, d] projection, and the int32
    mask (each row's length in the top half of L) or None."""
    proj = torch.randn((b, l, 3, h, d), generator=gen).to(device, dtype)
    q, k, v = proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]
    mask = None
    if masked:
        lo = l // 2 + 1 if l > 32 else 1
        lens = torch.randint(lo, l + 1, (b,), generator=gen)
        mask = (torch.arange(l)[None, :] < lens[:, None]).to(
            device, torch.int32)
    return q, k, v, mask


def _call(torch, lib, q, k, v, mask, out):
    # The current stream at each call: under graph capture it is the
    # capturing stream.
    b, l, h, d = q.shape
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr() if mask is not None else None, None,
        out.data_ptr(), b, l, h, d, *strides, d ** -0.5,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(lib.flash_attention_error_string(rc))


def against(torch, other_path, device, gen, smi) -> None:
    """This source's kernel against OTHER.cu's at the table's shapes."""
    from ..utils.cudatime import graph_time_ms
    from .attention import attend

    libs = build_all(["kernel", "other"],
                     {"other": open(other_path).read()})
    order = ("other", "kernel", "kernel_again", "other_again")
    for name, h, d, dtype_name, sizes, masked in TABLE_SHAPES:
        dtype = getattr(torch, dtype_name)
        ms = dict.fromkeys(order, 0.0)
        err = dict.fromkeys(("other", "kernel"), 0.0)
        for b, l in sizes:
            q, k, v, mask = _inputs(torch, gen, device, b, l, h, d, dtype,
                                    masked)
            out = torch.empty((b, l, h, d), dtype=dtype, device=device)
            ref = attend(q, k, v, kv_mask=mask).float()
            for lib_name in err:
                _call(torch, libs[lib_name], q, k, v, mask, out)
                torch.cuda.synchronize()
                err[lib_name] = max(err[lib_name],
                                    (out.float() - ref).abs().max().item())
            for key in order:
                lib = libs[key.replace("_again", "")]
                ms[key] += graph_time_ms(
                    lambda: _call(torch, lib, q, k, v, mask, out))
            del q, k, v, out, ref
            torch.cuda.empty_cache()
        print(json.dumps({"shape": name, "heads": h, "head_dim": d,
                          "dtype": dtype_name, "sizes": sizes,
                          "ms_summed": ms, "max_abs_err": err,
                          "other": other_path, "card": smi}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--against", default=None)
    args = parser.parse_args()
    import torch

    from ..utils.cudatime import graph_time_ms
    from .attention import attend

    if not torch.cuda.is_available():
        raise SystemExit("generic_ablation: no CUDA device is visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(args.seed)
    if args.against:
        against(torch, args.against, device, gen, smi)
        return 0
    libs = build_all(VARIANTS)
    for model, b, l, h, d, dtype_name, masked in SHAPES:
        dtype = getattr(torch, dtype_name)
        q, k, v, mask = _inputs(torch, gen, device, b, l, h, d, dtype, masked)
        out = torch.empty((b, l, h, d), dtype=dtype, device=device)
        ref = attend(q, k, v, kv_mask=mask).float()
        row = {"model": model, "shape": [b, l, h, d], "dtype": dtype_name,
               "ms": {}, "max_abs_err": {}, "card": smi}
        for name, lib in libs.items():
            _call(torch, lib, q, k, v, mask, out)
            torch.cuda.synchronize()
            row["max_abs_err"][name] = (out.float() - ref).abs().max().item()
            row["ms"][name] = graph_time_ms(
                lambda: _call(torch, lib, q, k, v, mask, out))
        row["ms"]["kernel_again"] = graph_time_ms(
            lambda: _call(torch, libs["kernel"], q, k, v, mask, out))
        print(json.dumps(row), flush=True)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
