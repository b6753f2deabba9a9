"""Probes of the flash-attention backward kernel (``csrc/flash_attention_bwd.cu``)
on one CUDA card, beside what ``chip_smoke.py`` gates.

    python3 tools/flash_bwd_probe.py [time] [accuracy]

``time``: ptxas's registers and spills for each instantiation, then the
bf16 and f32 backward at the ``train_long`` layer shape (1, 10,240,
16/2, 128, causal): device ms per call (two medians of three, L2
flushed between calls, ``chip_smoke.device_ms``), each launch's device
ms from ``torch.profiler``, and the largest distance from the plain
version relative to each gradient's max.

``accuracy``: the f32 backward at that shape with 2,048 and 10,240
tokens against the float64 gradient (``ref.attention_grads_f64``), and
the plain version beside it: per gradient the max distance relative to
the gradient's max, and the bias (the mean signed error along the
float64 value's sign, relative to the mean |value|).
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as kfab  # noqa: E402

SHAPE = (1, 10240, 10240, 16, 2, 128)


def ptxas_table() -> None:
    log = _build.build_all()["flash_attention_bwd"].with_suffix(".log").read_text()
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?(dkdv_kernel|dq_kernel|rows_kernel|"
                      r"split_kernel)(I[^E]*E)?", line)
        if m:
            name = m.group(1) + (m.group(2) or "")
        if "spill" in line or "Used" in line:
            print(f"ptxas {name}: {line.strip()}", flush=True)


def probe_time(device) -> None:
    ptxas_table()
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    rng = np.random.default_rng(7)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = cs.attention_case(rng, device, *SHAPE, dtype=dtype)
        dout = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(device, dtype)
        o, lse = kfa.flash_attention(q, k, v, causal=True, return_lse=True)

        def kernel():
            return kfab.flash_attention_bwd(q, k, v, o, lse, dout, causal=True)

        k1, _ = cs.device_ms(kernel, 3, flush)
        k2, _ = cs.device_ms(kernel, 3, flush)
        got = kernel()
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, causal=True, block_q=2048,
                                           block_k=2048)
        rel = max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
                  for g, w in zip(got, want))
        print(f"time {dtype} {SHAPE}: {k1:.3f} / {k2:.3f} ms; largest distance from the plain "
              f"version {rel:.3g} of a gradient's max", flush=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            kernel()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                print(f"  {e.key[:90]}: {e.self_device_time_total / 1e3:.3f} ms", flush=True)
        del q, k, v, dout, o, lse, got, want
        torch.cuda.empty_cache()


def probe_accuracy(device) -> None:
    for tokens in (2048, 10240):
        rng = np.random.default_rng(7)
        q, k, v = cs.attention_case(rng, device, 1, tokens, tokens, 16, 2, 128)
        dout = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(device)
        o, lse = kfa.flash_attention(q, k, v, causal=True, return_lse=True)
        got = kfab.flash_attention_bwd(q, k, v, o, lse, dout, causal=True)
        p_out, p_lse = ref.flash_attention_lse_ref(q, k, v, causal=True, block_q=2048,
                                                   block_k=2048)
        plain = ref.flash_attention_bwd_ref(q, k, v, p_out, p_lse, dout, causal=True,
                                            block_q=2048, block_k=2048)
        for name, g, p, x in zip(("dq", "dk", "dv"), got, plain, ref.attention_grads_f64(q, k, v, dout, causal=True)):
            top, mean = float(x.abs().max()), float(x.abs().mean())
            e_g, e_p = g.double() - x, p.double() - x
            print(f"f32 {tokens} tokens {name}: kernel {float(e_g.abs().max()) / top:.3g} "
                  f"(bias {float((e_g * x.sign()).mean()) / mean:.3g}), plain "
                  f"{float(e_p.abs().max()) / top:.3g} (bias "
                  f"{float((e_p * x.sign()).mean()) / mean:.3g}); kernel from plain "
                  f"{float((g - p).abs().max()) / top:.3g}", flush=True)
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    modes = sys.argv[1:] or ["time", "accuracy"]
    cs.phase_build()
    for mode in modes:
        {"time": probe_time, "accuracy": probe_accuracy}[mode](device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
