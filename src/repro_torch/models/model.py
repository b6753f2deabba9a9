"""Arch config -> init, prefill and decode, layer group by layer group.

The JAX package's ``models/model.py`` for the serving path, for every
family: dense, MoE, SSM, hybrid and encoder-decoder.  Layers with
identical structure form a *group* whose parameters are stacked on a
leading layer axis, as the JAX package stacks them for ``lax.scan``; here
a Python loop walks the stack.  The parameter tree is the JAX package's
after ``strip_p``: ``{"embed", "final_norm", "groups": [group][i][...]}``
with a leading layer axis on every group leaf, and for an
encoder-decoder ``"encoder": {"layers": (stacked layer,), "norm"}``.

Public entry points (cfg/dims describe the model):

    init_params(generator, cfg, dims, device=None) -> params
    forward(params, cfg, dims, tokens, ...)        -> (logits, aux)     [train]
    lm_loss(logits, labels, true_vocab, ...)       -> scalar
    init_cache(cfg, dims, batch, max_len, ...)     -> Cache
    prefill(params, cfg, dims, tokens, ...)        -> (logits_last, Cache)
    decode_step(params, cfg, dims, token, cache)   -> (logits, Cache)

Under a mesh, ``forward``, ``prefill``, ``decode_step`` and ``init_cache``
take ``tp`` (a ``launch.tensor_parallel.TensorParallel``: the rank's block
of the heads, ``d_ff`` columns, vocabulary, experts and SSM heads; in
training, with ``seq_parallel``, its block of the sequence between
blocks) and ``dp`` (a ``launch.data_parallel.DataParallel`` over the
batch axes: the FSDP-placed weights gathered one layer at a time, the MoE
routing groups of the global batch, and with ``seq_sharded`` the rank's
block of the cache's positions), and ``lm_loss`` takes ``tp``;
``launch/serve.py`` and ``launch/train.py`` build both from a mesh.

Rematerialisation (``forward``'s ``remat``) wraps each layer period, the
JAX package's scan body, in ``torch.utils.checkpoint``: ``"none"`` keeps
every activation, ``"full"`` recomputes the period in the backward pass,
``"dots"`` keeps the outputs of products without batch dimensions (the
weight products) and recomputes the rest, as
``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` does.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.utils import checkpoint as _ckpt

from .. import platform
from ..tree import tree_flatten
from . import blocks
from .config import ArchConfig, Dims, _layer_list
from .layers import (dense_init, embed, init_embedding, init_rmsnorm, mask_padded_vocab,
                     rmsnorm)

ENCODER_SPEC = ("A", False)        # every encoder layer: attention and a dense FFN

# ---------------------------------------------------------------------------
# Layer grouping and tree helpers
# ---------------------------------------------------------------------------


def layer_groups(cfg: ArchConfig) -> list[tuple[tuple, int]]:
    """[(period_specs, repeat_count)] -- consecutive equal periods merge."""
    specs = _layer_list(cfg)
    period = cfg.period
    if len(specs) % period:
        raise ValueError(f"{cfg.name}: {len(specs)} layers are not whole periods of {period}")
    periods = [tuple(specs[i * period:(i + 1) * period])
               for i in range(len(specs) // period)]
    groups: list[tuple[tuple, int]] = []
    for p in periods:
        if groups and groups[-1][0] == p:
            groups[-1] = (p, groups[-1][1] + 1)
        else:
            groups.append((p, 1))
    return groups


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _stack(trees: list):
    """Trees of equal structure -> one tree with a leading stacked axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(trees)


def _layer(tree, index: int):
    """The ``index``-th layer of a stacked tree (views, no copies)."""
    return _tree_map(lambda x: x[index], tree)


def _unstack(tree, count: int) -> list:
    """Every layer of a stacked tree, as views.  One ``unbind`` per leaf:
    its backward stacks the layers' gradients once, where indexing would
    add a zero-filled stack per layer."""
    leaves, treedef = tree_flatten(tree)
    per_leaf = [x.unbind(0) for x in leaves]
    return [treedef.unflatten(layers[i] for layers in per_leaf) for i in range(count)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ArchConfig, dims: Dims, device=None) -> dict:
    """Random float32 parameters drawn from ``generator`` (on its device),
    placed on ``device`` (None: the CUDA card).  On the ``meta`` device
    nothing is drawn: the abstract tree, whose shapes and
    :func:`param_axes` are those of the real one."""
    device = platform.resolve(device)
    params: dict[str, Any] = {
        "embed": init_embedding(generator, dims.vocab, cfg.d_model, device=device),
        "final_norm": init_rmsnorm(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (cfg.d_model, dims.vocab), device=device)
    groups = []
    for pspec, count in layer_groups(cfg):
        layers = [tuple(blocks.init_layer(generator, dims, spec, cross=cfg.is_encdec,
                                          device=device)
                        for spec in pspec) for _ in range(count)]
        groups.append(_stack(layers))
    params["groups"] = groups
    if cfg.is_encdec:
        layers = [(blocks.init_layer(generator, dims, ENCODER_SPEC, device=device),)
                  for _ in range(cfg.encoder_layers)]
        params["encoder"] = {"layers": _stack(layers),
                             "norm": init_rmsnorm(cfg.d_model, device=device)}
    return params


# The logical axes of every parameter, by its module and name: the JAX
# package's ``P(value, axes)`` annotations in ``models/{layers, attention,
# ssm, moe}.py``.  Stacked layer leaves add a leading "layers" axis.
_ATTN = {"wq": ("embed", "heads", "hd"), "wk": ("embed", "kv", "hd"),
         "wv": ("embed", "kv", "hd"), "wo": ("heads", "hd", "embed_out"),
         "bq": ("heads", "hd"), "bk": ("kv", "hd"), "bv": ("kv", "hd")}
_MLP = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed_out")}
_AXES = {
    None: {"embed": ("vocab", "embed"), "lm_head": ("embed", "vocab"),
           "final_norm": ("norm",), "norm": ("norm",), "mixer_norm": ("norm",),
           "cross_norm": ("norm",), "mlp_norm": ("norm",)},
    "attn": _ATTN, "cross": _ATTN, "mlp": _MLP, "shared": _MLP,
    "mamba": {"wz": ("embed", "ssm_heads", "hd"), "wx": ("embed", "ssm_heads", "hd"),
              "wB": ("embed", "ssm_group", "state"), "wC": ("embed", "ssm_group", "state"),
              "wdt": ("embed", "ssm_heads"), "conv_x": ("ssm_heads", "hd", "conv"),
              "conv_bc": ("conv_ch", "conv"), "A_log": ("ssm_heads",),
              "dt_bias": ("ssm_heads",), "D": ("ssm_heads",), "norm": ("ssm_heads", "hd"),
              "wo": ("ssm_heads", "hd", "embed_out")},
    "moe": {"router": ("embed", "experts"), "w_gate": ("experts", "embed", "expert_mlp"),
            "w_up": ("experts", "embed", "expert_mlp"),
            "w_down": ("experts", "expert_mlp", "embed_out")},
}


def param_axes(params) -> dict:
    """The logical-axes tree of a parameter tree (a tuple of axis names
    per leaf): the second half of the JAX package's ``split_tree``, which
    ``launch/shardings.py`` maps to mesh axes."""
    def walk(tree, module, stacked):
        if isinstance(tree, dict):
            out = {}
            for key, sub in tree.items():
                if isinstance(sub, torch.Tensor):
                    axes = _AXES[module if module in _AXES else None][key]
                    if sub.ndim != len(axes) + stacked:
                        raise ValueError(f"{key}: {sub.ndim} dims, axes {axes}")
                    out[key] = ("layers",) * stacked + axes
                else:
                    out[key] = walk(sub, key, stacked or key in ("groups", "layers"))
            return out
        return type(tree)(walk(sub, module, stacked) for sub in tree)
    return walk(params, None, False)


def _cast(tree, dtype):
    """float32 leaves to ``dtype`` (no copy when it is float32)."""
    return _tree_map(lambda x: x.to(dtype) if x.dtype == torch.float32 else x, tree)


def _positions(tokens):
    b, s = tokens.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)


def _logits(wp, cfg: ArchConfig, x, tp=None, *, gather: bool = True):
    """Logits over the (padded) vocabulary; under ``tp`` the rank's block
    of the vocabulary, its columns all-gathered with ``gather`` (before
    any ``mask_padded_vocab``), else the block (training's loss)."""
    if tp is not None:
        x = tp.copy(x)
    if cfg.tie_embeddings:
        lg = torch.einsum("bsd,vd->bsv", x, wp["embed"])
    else:
        lg = torch.einsum("bsd,dv->bsv", x, wp["lm_head"])
    return lg if tp is None or not gather else tp.gather(lg, -1)


def _zero_aux(device):
    return {"moe_lb_loss": torch.zeros((), dtype=torch.float32, device=device),
            "moe_z_loss": torch.zeros((), dtype=torch.float32, device=device)}


REMAT_MODES = ("none", "full", "dots")


def _no_batch_dot_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of products without batch dimensions, recompute everything else.
    ``torch.matmul`` and ``torch.einsum`` give such a product (a weight
    product, ``bsd,dhk->bshk``) as ``mm`` or as a ``bmm`` of one batch;
    attention's ``bqkgh,bskh->bkgqs`` is a ``bmm`` over B x KV (which
    counts as unbatched when B x KV is 1: that only keeps more)."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, remat: str):
    """``fn`` run under the rematerialisation of mode ``remat``."""
    if remat not in REMAT_MODES:
        raise ValueError(remat)
    if remat == "none":
        return fn
    context_fn = (functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                    _no_batch_dot_policy)
                  if remat == "dots" else _ckpt.noop_context_fn)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)
    return wrapped


def _run_groups(params, cfg, dims, x, positions, *, causal, enc_mem=None, remat="none",
                ssm_chunk=128, collect_cache=False, attn_chunk=2048,
                probs_dtype=torch.float32, impl=None, dp=None, tp=None):
    """Every layer of every group in order, each layer period under
    ``remat``.  Returns (x, aux, caches|None): the MoE aux losses summed
    over layers (None without experts), caches stacked per group as the
    parameters are.  Under ``dp`` a period gathers its parameters inside
    its remat region; under ``tp`` each layer runs on the rank's block of
    the model axis, and its output, and in the backward the gradient that
    reaches it, are held equal across the model group
    (``tp.check_replicated``, ``tp.check_grad``)."""
    aux = _zero_aux(x.device) if cfg.num_experts > 0 else None
    caches = [] if collect_cache else None
    for gi, ((pspec, count), gparams) in enumerate(zip(layer_groups(cfg), params["groups"])):

        def body(x, aux, pslice, _pspec=pspec, _gi=gi):
            if dp is not None:
                pslice = dp.gather_layer(pslice, ("groups", _gi))
            outs = []
            for i, spec in enumerate(_pspec):
                x, cache_out, aux = blocks.apply_layer(
                    pslice[i], x, dims, spec, positions=positions, causal=causal,
                    enc_mem=enc_mem, aux=aux, ssm_chunk=ssm_chunk, attn_chunk=attn_chunk,
                    probs_dtype=probs_dtype, impl=impl, dp=dp, tp=tp,
                    final_state=collect_cache)
                if tp is not None:
                    tp.check_replicated(x, f"group {_gi} layer {i}")
                outs.append(cache_out)
            return x, aux, (tuple(outs) if collect_cache else None)

        body = _remat_wrap(body, remat)
        outs = []
        for li, pslice in enumerate(_unstack(gparams, count)):
            x, aux, layer_out = body(x, aux, pslice)
            if tp is not None:
                tp.check_grad(x, f"group {gi} period {li}")
            if collect_cache:
                outs.append(layer_out)
        if collect_cache:
            caches.append(_stack(outs))
    return x, aux, caches


def _encode(params, cfg, dims, enc_feats, *, remat="none", impl=None, dp=None, tp=None):
    """Encoder stack over precomputed frontend features (B, S_src, d):
    non-causal self-attention layers, each under ``remat``, then the
    encoder's norm (under ``tp.seq_parallel`` on the rank's block of the
    source positions; the rotary positions stay global)."""
    positions = _positions(enc_feats)
    x = enc_feats if tp is None else tp.seq_block(enc_feats)

    def body(x, pslice):
        if dp is not None:
            pslice = dp.gather_layer(pslice, ("encoder", "layers"))
        x, _, _ = blocks.apply_layer(pslice[0], x, dims, ENCODER_SPEC, positions=positions,
                                     causal=False, impl=impl, tp=tp)
        if tp is not None:
            tp.check_replicated(x, "encoder layer")
        return x

    body = _remat_wrap(body, remat)
    for pslice in _unstack(params["encoder"]["layers"], cfg.encoder_layers):
        x = body(x, pslice)
    return rmsnorm(params["encoder"]["norm"], x, cfg.rms_eps)


# ---------------------------------------------------------------------------
# Forward (train / full-sequence)
# ---------------------------------------------------------------------------

def forward(params, cfg: ArchConfig, dims: Dims, tokens, *, enc_feats=None,
            compute_dtype=torch.bfloat16, remat: str = "full", ssm_chunk: int = 128,
            attn_chunk: int = 2048, probs_dtype=torch.float32, impl: str | None = None,
            dp=None, tp=None):
    """Teacher-forced full-sequence forward.  tokens (B, S) integers.

    Returns (logits (B, S, vocab_padded) float32, aux): aux holds the MoE
    load-balance and router z losses summed over layers (zeros without
    experts).  float32 leaves are cast to ``compute_dtype`` here, so
    gradients reach float32 parameters.  ``enc_feats`` (B, S_src, d) are
    the encoder-decoder's frontend features; ``remat`` is one of
    :data:`REMAT_MODES` (others raise ``ValueError``); ``probs_dtype`` the
    attention probabilities' type; ``impl`` as for :func:`prefill`.
    ``dp`` (a ``launch.data_parallel.DataParallel``) runs a data-parallel
    rank: ``params`` and ``tokens`` are the rank's own blocks and rows,
    gathered as the layers need them.  ``tp`` (a ``launch.tensor_parallel
    .TensorParallel`` of ``dims.tp`` ranks, else ``ValueError``) runs a
    rank of the model axis on its blocks of the parameters; the logits are
    then the rank's block of the vocabulary, (B, S, vocab_padded / tp),
    which :func:`lm_loss` takes with the same ``tp``.  With
    ``tp.seq_parallel`` the activations between blocks hold the rank's
    block of the sequence (S a multiple of tp, else ``ValueError``).
    """
    if remat not in REMAT_MODES:
        raise ValueError(remat)
    if tp is not None and tp.size != dims.tp:
        raise ValueError(f"Dims built for tp={dims.tp} on a model axis of {tp.size}")
    wp = _cast(params, compute_dtype)
    if dp is not None:
        wp = dp.gather_top(wp)
    device = wp["embed"].device
    tokens = torch.as_tensor(tokens, device=device)
    if tp is not None and tokens.shape[1] % tp.seq_shards:
        raise ValueError(f"{tokens.shape[1]} positions do not split over {tp.seq_shards} "
                         f"sequence blocks")
    x = embed(wp["embed"], tokens, tp)
    enc_mem = None
    if cfg.is_encdec:
        if enc_feats is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: forward needs enc_feats")
        enc_mem = _encode(wp, cfg, dims,
                          torch.as_tensor(enc_feats, device=device).to(compute_dtype),
                          remat=remat, impl=impl, dp=dp, tp=tp)
    x, aux, _ = _run_groups(wp, cfg, dims, x, _positions(tokens), causal=True,
                            enc_mem=enc_mem, remat=remat, ssm_chunk=ssm_chunk,
                            attn_chunk=attn_chunk, probs_dtype=probs_dtype, impl=impl, dp=dp,
                            tp=tp)
    x = rmsnorm(wp["final_norm"], x, cfg.rms_eps)
    lg = _logits(wp, cfg, x, tp, gather=False).to(torch.float32)
    return lg, (aux if aux is not None else _zero_aux(device))


def lm_loss(logits, labels, true_vocab: int, *, mask=None, tp=None):
    """Cross entropy over the *unpadded* vocabulary (padded columns
    masked), the mean over tokens, or over ``mask``'s tokens.  Under a
    ``tp`` of more than one rank ``logits`` are the rank's vocabulary
    block (:func:`forward`), and the loss is the whole vocabulary's, the
    same bits on every rank (:func:`_vocab_parallel_nll`)."""
    if tp is not None and tp.size > 1:
        return _token_mean(_vocab_parallel_nll(logits, labels, true_vocab, tp), mask)
    lg = mask_padded_vocab(logits, true_vocab)
    lse = torch.logsumexp(lg, dim=-1)
    labels = torch.as_tensor(labels, device=lg.device).to(torch.int64)
    # The JAX package sums lg * one_hot(labels) over the vocabulary.  Each
    # term but the label's is +-0 times a finite logit, so a gather of the
    # label's logit is the same number bit for bit, without a (B, S, V)
    # float32 one-hot (2.5 GB at 4,096 tokens of a 151,936 vocabulary).
    # A label outside [0, V) has an all-zero one-hot: its term is 0.
    valid = (labels >= 0) & (labels < lg.shape[-1])
    num = torch.gather(lg, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
    nll = lse - torch.where(valid, num, 0.0)
    return _token_mean(nll, mask)


def _token_mean(nll, mask):
    if mask is None:
        return nll.mean()
    mask = torch.as_tensor(mask, device=nll.device).to(nll.dtype)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _vocab_parallel_nll(logits, labels, true_vocab: int, tp):
    """Per-token cross entropy from the ranks' vocabulary blocks, as GSPMD
    computes it from ``logits_pspec``: the row max all-reduced over the
    model group (a max is exact; it only steadies the exponentials, so it
    takes no gradient), the sum of exponentials all-reduced (*g*: each
    rank's gradient of its block is the softmax's), and the label's logit
    taken from the rank that owns it, zeros elsewhere, summed.  Padded
    columns are masked by their global index.  The logits are never
    gathered: at 10,240 tokens of a 151,936 vocabulary that is 3.1 GB a
    rank."""
    block = logits.shape[-1]
    start = tp.rank * block
    col = start + torch.arange(block, device=logits.device)
    lg = torch.where(col >= true_vocab, torch.finfo(logits.dtype).min, logits)
    m = lg.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    lse = m + torch.log(tp.all_reduce(torch.exp(lg - m[..., None]).sum(dim=-1)))
    labels = torch.as_tensor(labels, device=lg.device).to(torch.int64)
    # as the one-process loss: a label outside [0, V) takes no logit
    local = labels - start
    own = (labels < block * tp.size) & (local >= 0) & (local < block)
    num = torch.gather(lg, -1, torch.where(own, local, 0)[..., None])[..., 0]
    return lse - tp.all_reduce(torch.where(own, num, 0.0))


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} {n} does not split over {parts} shards")
    return n // parts


class Cache(NamedTuple):
    """Decode state.  groups: per layer group, the stacked per-layer caches."""
    groups: tuple
    lens: torch.Tensor            # (B,) int32 tokens already in cache


def init_cache(cfg: ArchConfig, dims: Dims, batch: int, max_len: int, src_len: int = 0, *,
               dtype=torch.bfloat16, device=None, tp=None, dp=None) -> Cache:
    """Zero decode state: K/V of ``max_len`` positions, mamba states, and
    for an encoder-decoder with ``src_len`` > 0 the memory K/V.

    Under a mesh, the rank's block of ``launch.shardings.cache_pspecs``'s
    layout of that state (``batch``, ``max_len`` and ``src_len`` are the
    whole cache's): KV / tp and SSM heads / tp under ``tp``; under ``dp``,
    batch / shards rows, or with ``seq_sharded`` every row and max_len /
    shards positions (src_len / shards memory rows), the rank's contiguous
    block.  A size the shards do not divide raises ``ValueError``."""
    device = platform.resolve(device)
    if dp is not None and dp.seq_sharded:
        max_len = _split(max_len, dp.world, "max_len")
        src_len = _split(src_len, dp.world, "src_len")
    elif dp is not None:
        batch = _split(batch, dp.world, "batch")
    tp_size = 1 if tp is None else tp.size
    groups = tuple(
        tuple(blocks.init_layer_cache(dims, spec, batch, max_len, src_len, stack=(count,),
                                      dtype=dtype, device=device, tp_size=tp_size)
              for spec in pspec)
        for pspec, count in layer_groups(cfg))
    return Cache(groups=groups, lens=torch.zeros((batch,), dtype=torch.int32, device=device))


def prefill(params, cfg: ArchConfig, dims: Dims, tokens, *, enc_feats=None,
            compute_dtype=torch.bfloat16, ssm_chunk: int = 128, attn_chunk: int = 2048,
            impl: str | None = None, tp=None, dp=None):
    """Process a full prompt; returns (last-token logits (B, 1, vocab)
    float32, Cache).

    ``tokens`` (B, S) go to the parameters' device, and so do the
    encoder-decoder's frontend features ``enc_feats`` (B, S_src, d).
    ``impl`` names the implementation of the flash-attention op of
    sequences longer than ``attention.CHUNKED_THRESHOLD`` (None: by
    device); ``ssm_chunk`` is the chunk of the mamba layers' scan.  The
    returned attention caches have length S; ``launch.serve`` re-bases
    them into a max_len cache.

    Under a mesh (``tp``, ``dp``; ``launch.serve.make_prefill`` builds
    them) ``params`` are the rank's blocks and ``tokens`` its rows (every
    row with ``dp.seq_sharded``); the logits cover the whole vocabulary,
    the caches the rank's heads and rows.
    """
    wp = _cast(params, compute_dtype)
    if dp is not None:
        wp = dp.gather_top(wp)
    device = wp["embed"].device
    tokens = torch.as_tensor(tokens, device=device)
    x = embed(wp["embed"], tokens, tp)
    enc_mem = None
    if cfg.is_encdec:
        if enc_feats is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: prefill needs enc_feats")
        enc_mem = _encode(wp, cfg, dims,
                          torch.as_tensor(enc_feats, device=device).to(compute_dtype),
                          impl=impl, dp=dp, tp=tp)
    x, _, caches = _run_groups(wp, cfg, dims, x, _positions(tokens), causal=True,
                               enc_mem=enc_mem, ssm_chunk=ssm_chunk, collect_cache=True,
                               attn_chunk=attn_chunk, impl=impl, dp=dp, tp=tp)
    x = rmsnorm(wp["final_norm"], x[:, -1:], cfg.rms_eps)
    b, s = tokens.shape
    cache = Cache(groups=tuple(caches),
                  lens=torch.full((b,), s, dtype=torch.int32, device=tokens.device))
    return _logits(wp, cfg, x, tp).to(torch.float32), cache


def decode_step(params, cfg: ArchConfig, dims: Dims, token, cache: Cache, *,
                compute_dtype=torch.bfloat16, tp=None, dp=None):
    """One token for every sequence.  token (B, 1) -> (logits (B, 1, vocab)
    float32, Cache).  The cache's K/V and mamba states are updated in
    place; the returned Cache holds the same tensors and ``lens + 1``.
    Decode attention is plain PyTorch (no kernel op), so there is no
    ``impl``.  Under a mesh (``tp``, ``dp``) as :func:`prefill`: the
    rank's blocks, rows and cache block (:func:`init_cache`), each
    layer's weights gathered over the batch axes as it runs."""
    wp = _cast(params, compute_dtype)
    if dp is not None:
        wp = dp.gather_top(wp)
    token = torch.as_tensor(token, device=wp["embed"].device)
    x = embed(wp["embed"], token, tp)
    for gi, ((pspec, count), gparams, gcache) in enumerate(zip(layer_groups(cfg), wp["groups"],
                                                               cache.groups)):
        for layer in range(count):
            pslice, cslice = _layer(gparams, layer), _layer(gcache, layer)
            if dp is not None:
                pslice = dp.gather_layer(pslice, ("groups", gi))
            for i, spec in enumerate(pspec):
                x, _ = blocks.decode_layer(pslice[i], x, dims, spec, cslice[i], cache.lens,
                                           tp=tp, dp=dp)
                if tp is not None:
                    tp.check_replicated(x, f"decode group {gi} layer {i}")
    x = rmsnorm(wp["final_norm"], x, cfg.rms_eps)
    return (_logits(wp, cfg, x, tp).to(torch.float32),
            Cache(groups=cache.groups, lens=cache.lens + 1))
