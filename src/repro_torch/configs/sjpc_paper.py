"""Paper-default SJPC parameters (§7 experimental setup).

DBLPtitles setting: d=6 super-shingles, online sketches w=1000 (rounded to
the pow2 1024), depth t=3, sampling ratio r=0.5, thresholds s=3..6.
"""
from repro_torch.core.sjpc import SJPCConfig

PAPER_DEFAULTS = SJPCConfig(d=6, s=3, ratio=0.5, width=1024, depth=3)
