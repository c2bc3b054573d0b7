"""Where the sm90 attention kernel's time goes: ablated builds, timed.

    python -m distributed_crawler_tpu_torch.ops.sm90_ablation [--seed N]
        [--buckets 32 128 512]

Each variant is `csrc/flash_attention_sm90.cu` with one piece of work taken
out, or one parameter changed, by a text substitution; an ablated variant's
output is wrong on purpose.  Every variant is built by nvcc (all started
together) into the git-ignored `_build/ablation/`, and timed at E5-small's
attention shape (batch 256, 12 heads of 32, bf16, each row's length in the
top half of its bucket) by CUDA-graph replay, all in one process on one
card.  It prints one JSON line per bucket: ms per variant, each variant's
largest error against the plain version, and the card's name and power
limit.  Needs a CUDA card and nvcc; torch is imported only when it runs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Dict, List, Tuple

from .. import kernels

SOURCE = kernels.CSRC_DIR / kernels.SOURCES["flash_attention_sm90"]
OUT_DIR = kernels.BUILD_DIR / "ablation"

_ITEM_ORDER = (
    "    const int q0 = (item % n_qtiles) * kBlockM;\n"
    "    const int h = item / n_qtiles;",
    "    const int h = item % (n_items / n_qtiles);\n"
    "    const int q0 = (item / (n_items / n_qtiles)) * kBlockM;")
_CONSUMERS_IDLE = ("      if (k0 >= 0 && (flags & 1)) {", "      if (false) {")
# The producer without its per-key work: every candidate tile loaded and
# computed whole, no mask or segment loads, no division.
_PRODUCER_MIN = [
    ("      need = __reduce_or_sync(0xffffffffu, need);\n"
     "      if (need == 0) continue;  // no row may see a key of this tile",
     "      need = 3u;"),
    ("      need |= (__all_sync(0xffffffffu, whole0) ? 4u : 0u) |\n"
     "              (__all_sync(0xffffffffu, whole1) ? 8u : 0u);",
     "      need |= 12u;"),
    ("          const int b = (k0 + lane + 32 * i) / L;",
     "          const int b = b_lo;"),
    ("          vm[i] = kv_mask != nullptr ? __ldg(kv_mask + t) : 1;",
     "          vm[i] = 1;"),
    ("          sg[i] = seg != nullptr ? __ldg(seg + t) : 0;",
     "          sg[i] = 0;"),
]

VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    "no_exp": [("= ex2(s[", "= (s[")],
    "no_qk": [("          wgmma_ss_m64n64k16(s, qdesc + 2 * kk, "
               "kdesc + 2 * kk, kk);  // +32 B", "")],
    "no_pv": [("            wgmma_rs_m64n32k16(o, pa[kk], "
               "vdesc + step);", "")],
    "no_row_max": [("        const float mn0 = fmaxf(m0, mx0), "
                    "mn1 = fmaxf(m1, mx1);",
                    "        const float mn0 = m0, mn1 = m1;")],
    "no_mask": [("        if (flags & 4) {", "        if (true) {")],
    "consumers_idle": [_CONSUMERS_IDLE],
    "producer_min": _PRODUCER_MIN,
    "floor": _PRODUCER_MIN + [_CONSUMERS_IDLE],
    "stages_2": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    "stages_8": [("constexpr int kStages = 4;", "constexpr int kStages = 8;")],
    "heads_fastest": [_ITEM_ORDER],
}


def variant_source(name: str, source: str) -> str:
    """The kernel's source with the variant's substitutions; raises when
    one no longer matches the source."""
    for old, new in VARIANTS[name]:
        if old not in source:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        source = source.replace(old, new)
    return source


def build_all(names) -> Dict[str, ctypes.CDLL]:
    from .attention import SM90_SIGNATURES

    nvcc = kernels.nvcc_path()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    source = SOURCE.read_text()
    procs = {}
    for name in names:
        src = OUT_DIR / f"{name}.cu"
        src.write_text(variant_source(name, source))
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-o", str(OUT_DIR / f"{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        for fn, (argtypes, restype) in SM90_SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--buckets", type=int, nargs="+",
                        default=[32, 128, 512])
    args = parser.parse_args()
    import torch

    from ..utils.cudatime import graph_time_ms
    from .attention import attend

    if not torch.cuda.is_available():
        raise SystemExit("sm90_ablation: no CUDA device is visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    libs = build_all(VARIANTS)
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(args.seed)
    for l in args.buckets:
        b, h, d = 256, 12, 32
        proj = torch.randn((b, l, 3, h, d), generator=gen).to(
            device, torch.bfloat16)
        q, k, v = proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]
        lo = l // 2 + 1 if l > 32 else 1
        lens = torch.randint(lo, l + 1, (b,), generator=gen)
        mask = (torch.arange(l)[None, :] < lens[:, None]).to(device)
        mask_i = mask.to(torch.int32)
        out = torch.empty((b, l, h, d), dtype=torch.bfloat16, device=device)
        ref = attend(q, k, v, kv_mask=mask).float()
        strides = [s for x in (q, k, v) for s in (x.stride(1), x.stride(2))]

        def call(lib):
            # The current stream at each call: under graph capture it is
            # the capturing stream.
            rc = lib.flash_attention_sm90_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i.data_ptr(),
                None, out.data_ptr(), b, l, h, d, *strides, d ** -0.5,
                torch.cuda.current_stream(device).cuda_stream)
            if rc != 0:
                raise RuntimeError(lib.flash_attention_sm90_error_string(rc))

        row = {"bucket": l, "ms": {}, "max_abs_err": {}, "card": smi}
        for name, lib in libs.items():
            call(lib)
            torch.cuda.synchronize()
            row["max_abs_err"][name] = (out.float() - ref).abs().max().item()
            row["ms"][name] = graph_time_ms(lambda: call(lib))
        row["ms"]["kernel_again"] = graph_time_ms(lambda: call(libs["kernel"]))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
