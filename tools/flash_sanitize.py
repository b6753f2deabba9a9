"""The toolkit's race and synchronisation checkers on the flash-attention
kernels, one small call each, on one CUDA card.

    python3 tools/flash_sanitize.py             # every check, logs to build/sanitize/
    python3 tools/flash_sanitize.py --one NAME  # the call alone, as the checker runs it

NAME is ``bwd_bf16`` or ``bwd_f32`` (the backward kernel at (1, 200,
200, 4 heads over 2, hd 64), causal, on its forward's out and lse) or
``fwd_f32`` (the f32 forward at (2, 64, 64, 4 over 2, 16), causal).
Each of ``compute-sanitizer --tool racecheck`` and ``--tool synccheck``
runs ``--one NAME``; the script prints each run's exit code and the
checker's own lines, and writes each whole log beside them.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as kfab  # noqa: E402

SANITIZER = "/usr/local/cuda/bin/compute-sanitizer"
CALLS = ("bwd_bf16", "bwd_f32", "fwd_f32")
OUT = ROOT / "build" / "sanitize"


def one(name: str) -> None:
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def draw(shape, dtype):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)

    if name == "fwd_f32":
        q = draw((2, 64, 4, 16), torch.float32)
        k, v = (draw((2, 64, 2, 16), torch.float32) for _ in range(2))
        out = kfa.flash_attention(q, k, v, causal=True)
    else:
        dtype = torch.bfloat16 if name == "bwd_bf16" else torch.float32
        q, dout = (draw((1, 200, 4, 64), dtype) for _ in range(2))
        k, v = (draw((1, 200, 2, 64), dtype) for _ in range(2))
        o, lse = kfa.flash_attention(q, k, v, causal=True, return_lse=True)
        out = kfab.flash_attention_bwd(q, k, v, o, lse, dout, causal=True)[0]
    torch.cuda.synchronize()
    print(f"{name}: ran, finite {bool(torch.isfinite(out).all())}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_sanitize: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
        return 0
    _build.build_all()
    OUT.mkdir(parents=True, exist_ok=True)
    for tool in ("racecheck", "synccheck"):
        for name in CALLS:
            run = subprocess.run([SANITIZER, "--tool", tool, sys.executable, __file__, "--one",
                                  name], capture_output=True, text=True, timeout=600)
            log = run.stdout + run.stderr
            (OUT / f"{tool}_{name}.log").write_text(log)
            print(f"== {tool} {name}: exit {run.returncode}", flush=True)
            for line in log.splitlines():
                if line.startswith("=========") and line.strip("= "):
                    print(f"   {line}", flush=True)
                elif line.startswith(f"{name}: ran") or "Error:" in line:
                    print(f"   {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
