"""Mamba2 / SSD (state-space duality) mixer: chunked scan and recurrent
decode, ported from the JAX package's ``models/ssm.py``.

The SSD recurrence per head (state N, head dim P):

    h_t = exp(a_t) * h_{t-1} + dt_t * (B_t outer x_t)        a_t = -exp(A_log)*dt_t
    y_t = C_t . h_t + D * x_t

Prefill uses the chunked form: a loop over length-L chunks (where the JAX
package scans) carries the (B, H, N, P) inter-chunk state; within a chunk
the quadratic "attention-like" form computes the intra-chunk
contributions with the decay mask exp(cum[i] - cum[j]).  Decode is the
O(1) recurrent step, with a (K-1)-deep causal-conv state.  The JAX package
runs this mixer outside any Pallas kernel, and so does the port (plain
PyTorch, in float32 where the JAX package computes in float32).

Under tensor parallelism (``tp=``) the SSM heads split over the model
axis: ``wz``, ``wx``, ``wdt``, ``conv_x``, ``A_log``, ``dt_bias``, ``D``
and ``norm`` hold the rank's contiguous block of heads (the gated norm is
per head, so it stays local), ``wo`` is row-parallel, and ``wB``, ``wC``
and ``conv_bc`` stay replicated (the "ssm_group" axis maps to no mesh
axis).  The rank's heads keep their *global* groups: with 8 groups over
2 ranks, rank 1's heads read groups 4..7, not 0..3 (:func:`_rank_groups`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import Dims
from .layers import dense_init, ones_init

DEFAULT_CHUNK = 128


def init_mamba(generator: torch.Generator, dims: Dims, *, device) -> dict:
    cfg = dims.cfg
    d, g, n, kconv = cfg.d_model, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    h, p = dims.ssm_heads, cfg.ssm_head_dim
    # A init in [1, 16] (mamba2 default): A_log = log(uniform)
    a_init = np.log(np.linspace(1.0, 16.0, h, dtype=np.float32))
    # dt bias ~ softplus^-1(uniform in [1e-3, 1e-1])
    dt0 = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), h, dtype=np.float32))
    dt_bias = dt0 + np.log(-np.expm1(-dt0))
    return {
        "wz": dense_init(generator, (d, h, p), device=device),
        "wx": dense_init(generator, (d, h, p), device=device),
        "wB": dense_init(generator, (d, g, n), device=device),
        "wC": dense_init(generator, (d, g, n), device=device),
        "wdt": dense_init(generator, (d, h), device=device),
        "conv_x": dense_init(generator, (h, p, kconv), scale=1.0 / np.sqrt(kconv),
                             device=device),
        "conv_bc": dense_init(generator, (2 * g * n, kconv), scale=1.0 / np.sqrt(kconv),
                              device=device),
        "A_log": torch.from_numpy(a_init.astype(np.float32)).to(device),
        "dt_bias": torch.from_numpy(dt_bias.astype(np.float32)).to(device),
        "D": ones_init((h,), device=device),
        "norm": ones_init((h, p), device=device),
        "wo": dense_init(generator, (h, p, d), scale=1.0 / np.sqrt(h * p), device=device),
    }


def _causal_conv(seq, weight, *, state=None):
    """Depthwise causal conv along time.  seq (B, S, C), weight (C, K).

    state: optional (B, K-1, C) left context (decode/prefill chaining);
    zeros when None.  Returns (out (B, S, C), new_state (B, K-1, C)).
    """
    b, s, c = seq.shape
    k = weight.shape[-1]
    if state is None:
        state = torch.zeros((b, k - 1, c), dtype=seq.dtype, device=seq.device)
    full = torch.cat([state, seq], dim=1)                       # (B, S+K-1, C)
    out = torch.zeros((b, s, c), dtype=torch.float32, device=seq.device)
    for i in range(k):                                          # K is 4: unrolled
        out = out + full[:, i:i + s, :].to(torch.float32) * weight[:, i].to(torch.float32)
    new_state = full[:, -(k - 1):, :] if k > 1 else full[:, :0, :]
    return out.to(seq.dtype), new_state


def _project(params, u, dims: Dims):
    """u (B, S, d) -> z, x, Bm, Cm, dt (pre-conv, pre-activation)."""
    z = torch.einsum("bsd,dhp->bshp", u, params["wz"])
    x = torch.einsum("bsd,dhp->bshp", u, params["wx"])
    bm = torch.einsum("bsd,dgn->bsgn", u, params["wB"])
    cm = torch.einsum("bsd,dgn->bsgn", u, params["wC"])
    dt = torch.einsum("bsd,dh->bsh", u, params["wdt"])
    return z, x, bm, cm, dt


def _conv_split(params, x, bm, cm, conv_state=None):
    """Apply the causal convs; returns activated x, B, C and new conv states."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    xs = x.reshape(b, s, h * p)
    cw = params["conv_x"].reshape(h * p, -1)
    bc = torch.cat([bm.reshape(b, s, g * n), cm.reshape(b, s, g * n)], dim=-1)
    st_x = None if conv_state is None else conv_state["x"]
    st_bc = None if conv_state is None else conv_state["bc"]
    xs, new_x = _causal_conv(xs, cw, state=st_x)
    bc, new_bc = _causal_conv(bc, params["conv_bc"], state=st_bc)
    xs = F.silu(xs).reshape(b, s, h, p)
    bc = F.silu(bc)
    bm = bc[..., :g * n].reshape(b, s, g, n)
    cm = bc[..., g * n:].reshape(b, s, g, n)
    return xs, bm, cm, {"x": new_x, "bc": new_bc}


def ssd_chunked(x, a, dt, bm, cm, *, chunk: int = DEFAULT_CHUNK, h0=None,
                final_state: bool = True):
    """Chunked SSD.  x (B,S,H,P), a/dt (B,S,H), bm/cm (B,S,G,N).

    Returns (y (B,S,H,P) fp32, h_final (B,H,N,P) fp32).  S must be a
    multiple of ``min(chunk, S)``.  Without ``final_state`` the last
    chunk's state update is skipped and h_final is None: a training
    forward discards the state, and XLA drops that update from the JAX
    package's compiled forward as dead code.
    """
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    hg = h // g
    l = min(chunk, s)
    if l <= 0 or s % l:
        raise ValueError(f"chunk {l} does not tile a sequence of {s}")
    nc = s // l

    xdt = x.to(torch.float32) * dt[..., None]                    # (B,S,H,P)
    xc = xdt.reshape(b, nc, l, h, p)
    ac = a.reshape(b, nc, l, h)
    bc_ = bm.to(torch.float32).reshape(b, nc, l, g, n)
    cc_ = cm.to(torch.float32).reshape(b, nc, l, g, n)
    hstate = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
              if h0 is None else h0)
    lower = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()   # i >= j

    ys = []
    for c in range(nc):
        xk, ak, bk, ck = xc[:, c], ac[:, c], bc_[:, c], cc_[:, c]
        cum = torch.cumsum(ak, dim=1)                            # inclusive (B,L,H)
        # ---- intra-chunk (quadratic in L) ----
        cb = torch.einsum("bign,bjgn->bijg", ck, bk)             # (B,L,L,G)
        decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
        w = torch.where(lower[None, :, :, None], decay, 0.0)     # (B,i,j,H)
        if g > 1:
            scores = torch.repeat_interleave(cb, hg, dim=3)      # (B,i,j,H)
        else:
            scores = cb.expand(b, l, l, h)
        scores = scores * w
        y = torch.einsum("bijh,bjhp->bihp", scores, xk)
        # inter-chunk: y_i += exp(cum_i) * C_i . h_in
        ckh = _group_to_heads(ck, h)                             # (B,L,H,N)
        y = y + torch.exp(cum)[..., None] * torch.einsum("bihn,bhnp->bihp", ckh, hstate)
        ys.append(y)
        if c == nc - 1 and not final_state:
            hstate = None
            break
        # state update
        last = cum[:, -1:, :]                                    # (B,1,H)
        wstate = torch.exp(last - cum)                           # (B,L,H)
        bkh = _group_to_heads(bk, h)                             # (B,L,H,N)
        s_new = torch.einsum("bjh,bjhn,bjhp->bhnp", wstate, bkh, xk)
        hstate = torch.exp(last[:, 0, :])[:, :, None, None] * hstate + s_new
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y, hstate


def _group_to_heads(t, h):
    """(B, L, G, N) -> (B, L, H, N) by repeating each group H/G times."""
    b, l, g, n = t.shape
    if g == h:
        return t
    return t[:, :, :, None, :].expand(b, l, g, h // g, n).reshape(b, l, h, n)


def _rank_groups(bm, cm, dims: Dims, tp):
    """B and C of the groups of this rank's heads.  Head j of the model
    reads group j // (H / G) (``ssd_chunked``'s ``hg = h // g`` and
    :func:`_group_to_heads` over all H heads), so the rank's block of
    heads from ``tp.rank * H_rank`` reads a contiguous run of groups that
    starts at that head's group, not at group 0."""
    if tp is None or tp.size == 1:
        return bm, cm
    heads, groups = dims.ssm_heads, dims.cfg.ssm_groups
    first, count = tp.block(heads)
    per_group = heads // groups
    if count % per_group and per_group % count:
        raise ValueError(f"{count} SSM heads a rank split groups of {per_group} heads")
    g0, g1 = first // per_group, (first + count - 1) // per_group + 1
    return bm[:, :, g0:g1], cm[:, :, g0:g1]


def mamba_block(params, u, dims: Dims, *, chunk: int = DEFAULT_CHUNK, conv_state=None,
                ssm_state=None, tp=None, final_state: bool = True):
    """Full-sequence mixer.  u (B, S, d) -> (out (B,S,d), new states).
    ``tp``: the rank's heads (module docstring); without ``final_state``
    the SSM state is not computed (None), as :func:`ssd_chunked`."""
    cfg = dims.cfg
    if tp is not None:
        u = tp.copy(u)
    z, x, bm, cm, dt = _project(params, u, dims)
    x, bm, cm, new_conv = _conv_split(params, x, bm, cm, conv_state)
    bm, cm = _rank_groups(bm, cm, dims, tp)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])           # (B,S,H)
    a = -torch.exp(params["A_log"]) * dt                                 # (B,S,H)
    y, h_final = ssd_chunked(x, a, dt, bm, cm, chunk=chunk, h0=ssm_state,
                             final_state=final_state)
    y = y + params["D"][:, None] * x.to(torch.float32)
    y = _gated_norm(params["norm"], y, z, cfg.rms_eps)
    out = torch.einsum("bshp,hpd->bsd", y.to(u.dtype), params["wo"])
    return (out if tp is None else tp.reduce(out)), {"conv": new_conv, "ssm": h_final}


def _gated_norm(scale, y, z, eps):
    """RMSNorm(y * silu(z)) * scale -- mamba2's gated output norm (per head)."""
    y = y * F.silu(z.to(torch.float32))
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * scale


def mamba_decode_step(params, u, dims: Dims, conv_state, ssm_state, *, tp=None):
    """One-token recurrent step.  u (B, 1, d).

    conv_state: {"x": (B,K-1,H*P), "bc": (B,K-1,2GN)}; ssm_state (B,H,N,P).
    Returns (out (B,1,d), new states); the inputs are not written.
    ``tp``: the rank's heads (H counts them).
    """
    cfg = dims.cfg
    if tp is not None:
        u = tp.copy(u)
    z, x, bm, cm, dt = _project(params, u, dims)
    x, bm, cm, new_conv = _conv_split(params, x, bm, cm, conv_state)
    bm, cm = _rank_groups(bm, cm, dims, tp)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])           # (B,1,H)
    a = -torch.exp(params["A_log"]) * dt
    h = params["A_log"].shape[0]
    bkh = _group_to_heads(bm.to(torch.float32), h)[:, 0]                 # (B,H,N)
    ckh = _group_to_heads(cm.to(torch.float32), h)[:, 0]
    xdt = x.to(torch.float32)[:, 0] * dt[:, 0][..., None]                # (B,H,P)
    ssm_state = (torch.exp(a[:, 0])[..., None, None] * ssm_state
                 + bkh[..., None] * xdt[:, :, None, :])                  # (B,H,N,P)
    y = torch.einsum("bhn,bhnp->bhp", ckh, ssm_state)[:, None]           # (B,1,H,P)
    y = y + params["D"][:, None] * x.to(torch.float32)
    y = _gated_norm(params["norm"], y, z, cfg.rms_eps)
    out = torch.einsum("bshp,hpd->bsd", y.to(u.dtype), params["wo"])
    return (out if tp is None else tp.reduce(out)), {"conv": new_conv, "ssm": ssm_state}


def init_mamba_state(dims: Dims, batch: int, dtype=torch.bfloat16, *, stack: tuple = (),
                     device, tp_size: int = 1) -> dict:
    """Zero decode state for one mamba layer, or for ``stack`` layers of it:
    conv states in ``dtype``, the SSM state in float32; a rank of a model
    axis of ``tp_size`` holds H / tp_size heads (the "bc" conv state, over
    the replicated groups, stays whole)."""
    cfg = dims.cfg
    h, p = dims.ssm_heads // tp_size, cfg.ssm_head_dim
    g, n, k = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    lead = tuple(stack) + (batch,)
    return {
        "conv": {"x": torch.zeros(lead + (k - 1, h * p), dtype=dtype, device=device),
                 "bc": torch.zeros(lead + (k - 1, 2 * g * n), dtype=dtype, device=device)},
        "ssm": torch.zeros(lead + (h, n, p), dtype=torch.float32, device=device),
    }
