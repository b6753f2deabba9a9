"""Architecture configuration and the derived dimensions, copied from the
JAX package's ``models/config.py`` (which imports no JAX).

``ArchConfig`` carries the published architecture hyper-parameters
verbatim (the configurations the port supports live in
``repro_torch.configs``).  ``Dims`` derives the padded dimensions of a
tensor-parallel degree: query heads padded up to a multiple of it, KV heads
repeat-expanded when there are fewer than it, and the vocabulary padded to
a multiple of 128.  The port runs on one card (``tp=1``).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int              # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_period: int = 1         # a layer is MoE iff layer % moe_period == moe_offset
    moe_offset: int = 0
    leading_dense_layers: int = 0
    capacity_factor: float = 1.25
    dense_ff: int = 0           # d_ff for non-MoE layers when it differs (deepseek)
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    # --- hybrid ---
    layer_pattern: str = ""     # one char per layer in a period: 'A' attn, 'M' mamba
    # --- enc-dec ---
    encoder_layers: int = 0     # > 0 => encoder-decoder
    # --- flags ---
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-5
    frontend: str = "none"      # 'audio'/'vision': inputs are precomputed embeddings
    # modality frontend stub: source features arrive as (B, S_src, d_model)

    # ------------------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.num_heads == 0

    @property
    def pattern(self) -> str:
        """Per-period layer pattern; uniform models are a period of 1."""
        if self.layer_pattern:
            return self.layer_pattern
        return "M" if self.attention_free else "A"

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def num_periods(self) -> int:
        assert self.num_layers % self.period == 0, (self.name, self.num_layers, self.period)
        return self.num_layers // self.period

    def is_moe_layer(self, layer_in_period: int) -> bool:
        if self.num_experts == 0:
            return False
        return layer_in_period % self.moe_period == self.moe_offset

    # SSM derived sizes
    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def supports_long_context(self) -> bool:
        """Sub-quadratic path exists iff some layers are attention-free."""
        return "M" in self.pattern

    def param_count(self) -> int:
        """Exact parameter count of the unpadded architecture."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d                         # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                     # lm head
        layers = _layer_list(self)
        for (kind, moe) in layers:
            n += d                                       # mixer norm
            if kind == "A":
                hd = self.head_dim
                n += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                n += self.num_heads * hd * d
                if self.qkv_bias:
                    n += (self.num_heads + 2 * self.num_kv_heads) * hd
            elif kind == "M":
                di, g, N, h = self.ssm_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
                n += d * (2 * di + 2 * g * N + h)        # in projections
                n += (di + 2 * g * N) * self.ssm_conv    # conv
                n += 3 * h + di                          # A_log, D, dt_bias, norm
                n += di * d                              # out proj
            if self.d_ff > 0:
                n += d                                   # mlp norm
                if moe:
                    fe = self.d_ff
                    n += d * self.num_experts            # router
                    n += self.num_experts * 3 * d * fe
                    n += self.num_shared_experts * 3 * d * fe
                else:
                    n += 3 * d * self.d_ff
        if self.is_encdec:
            # encoder layers: self-attn + mlp (+ cross-attn params in decoder
            # are already counted above? no -- add cross attn for decoder)
            hd = self.head_dim
            enc = self.encoder_layers * (
                2 * d + d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d + 3 * d * self.d_ff)
            cross = self.num_layers * (
                d + d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)
            n += enc + cross
        n += d                                           # final norm
        return n

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top-k + shared only)."""
        if self.num_experts == 0:
            return self.param_count()
        d, fe = self.d_model, self.d_ff
        total = self.param_count()
        layers = _layer_list(self)
        n_moe = sum(1 for (_, moe) in layers if moe)
        inactive = n_moe * (self.num_experts - self.num_experts_per_tok) * 3 * d * fe
        return total - inactive


def _layer_list(cfg: ArchConfig) -> list[tuple[str, bool]]:
    """[(kind, is_moe)] for every decoder layer."""
    out = []
    for layer in range(cfg.num_layers):
        lp = layer % cfg.period
        kind = cfg.pattern[lp]
        moe = cfg.is_moe_layer(lp) and layer >= cfg.leading_dense_layers
        out.append((kind, moe))
    return out


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class Dims:
    """Mesh-derived dimensions (see module docstring)."""
    cfg: ArchConfig
    tp: int
    heads: int            # padded query heads
    kv_heads: int         # expanded kv heads
    vocab: int            # padded vocab
    ssm_heads: int

    @property
    def q_per_kv(self) -> int:
        return self.heads // self.kv_heads

    @property
    def attn_pad_waste(self) -> float:
        if self.cfg.num_heads == 0:
            return 0.0
        return self.heads / self.cfg.num_heads - 1.0


def compute_dims(cfg: ArchConfig, tp: int = 1) -> Dims:
    if cfg.attention_free:
        heads = kv = 0
    else:
        heads = pad_to(cfg.num_heads, tp)
        kv = cfg.num_kv_heads
        if kv < tp:
            assert tp % kv == 0 or kv % tp == 0
            kv = tp if tp % kv == 0 else kv
        # kv heads must also divide padded query heads evenly
        while heads % kv != 0:
            kv += 1
        assert heads % kv == 0
    vocab = pad_to(cfg.vocab_size, max(128, tp))
    ssm_heads = pad_to(cfg.ssm_heads, tp) if "M" in cfg.pattern else 0
    return Dims(cfg=cfg, tp=tp, heads=heads, kv_heads=kv, vocab=vocab,
                ssm_heads=ssm_heads)
