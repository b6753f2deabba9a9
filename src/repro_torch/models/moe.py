"""Mixture-of-Experts with GShard/Switch-style capacity dispatch, ported
from the JAX package's ``models/moe.py``.

Dispatch is the einsum formulation: one-hot dispatch and combine tensors
over token groups of ``GROUP`` tokens (``min(GROUP, tokens)``), each
expert taking at most ``capacity`` tokens of a group.  The JAX package
computes these einsums outside any Pallas kernel, and so does the port
(``torch.einsum`` in the activations' dtype).

Supports shared experts (DeepSeek-MoE: always-on experts added to the
routed output) and returns the load-balancing and router-z auxiliary
losses.

Under tensor parallelism (``tp=``) the experts split over the model axis:
the rank keeps E / tp of them and the matching block of the router's
columns.  The router logits are all-gathered before the softmax and
``ranked_top_k``, so every rank routes on all E experts with the same
ties; dispatch and combine then take the rank's experts' slice, and the
routed output is a partial sum over the group.  ``moe_capacity`` stays a
function of the global E.

The backward of that slice is a trap: each rank sends back only its
experts' part of d(combine), and through the top-k gates and the softmax
that part reaches every expert's logit, so the rank's block of d(router
logits) is a partial too, and the logits' gather keeps only a block.
The probabilities that feed the dispatch therefore pass through
``tp.sum_grads`` (*f*: the ranks' partial gradients summed, a (G, S, E)
all-reduce, far smaller than combine's (G, S, E, C)); the aux losses read
the probabilities before it, since their gradient is already whole on
every rank and summing it would count it tp times.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import dense_init, init_mlp, mlp

GROUP = 1024


def init_moe(generator: torch.Generator, d: int, ff: int, num_experts: int,
             num_shared: int, *, device) -> dict:
    p = {
        "router": dense_init(generator, (d, num_experts), scale=0.02, device=device),
        "w_gate": dense_init(generator, (num_experts, d, ff), device=device),
        "w_up": dense_init(generator, (num_experts, d, ff), device=device),
        "w_down": dense_init(generator, (num_experts, ff, d), device=device),
    }
    if num_shared:
        p["shared"] = init_mlp(generator, d, ff * num_shared, device=device)
    return p


def ranked_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis, largest first, the lower
    index first among equal values, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order among ties): (values, indices)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]


def _dispatch_tensors(router_probs, top_k: int, capacity: int):
    """router_probs (G, S, E) -> dispatch (G, S, E, C) 0/1 and combine
    (G, S, E, C) gate weights in the probabilities' dtype, the
    renormalised top-k gates (G, S, K) and the expert indices (G, S, K).

    Sequential-choice position assignment (Switch Transformer): the k-th
    choice of every token is placed after all (k-1)-th choices, so earlier
    choices win capacity; a choice past its expert's capacity is dropped.
    """
    g, s, e = router_probs.shape
    dtype = router_probs.dtype
    gates, idx = ranked_top_k(router_probs, top_k)              # (G,S,K)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    dispatch = torch.zeros((g, s, e, capacity), dtype=dtype, device=router_probs.device)
    combine = torch.zeros_like(dispatch)
    # expert fill counts carried across the K sequential choices
    fill = torch.zeros((g, e), dtype=torch.int64, device=router_probs.device)
    for k in range(top_k):
        onehot = F.one_hot(idx[:, :, k], e)                           # (G,S,E) int64
        # position of each token within its expert for this choice
        pos_in_e = torch.cumsum(onehot, dim=1) - onehot + fill[:, None, :]
        pos = (pos_in_e * onehot).sum(-1)                             # (G,S)
        keep = pos < capacity
        oh_cap = F.one_hot(torch.clamp(pos, 0, capacity - 1), capacity).to(dtype)
        sel = onehot.to(dtype) * keep[..., None].to(dtype)
        dispatch = dispatch + sel[..., None] * oh_cap[:, :, None, :]
        combine = combine + (sel * gates[:, :, k:k + 1])[..., None] * oh_cap[:, :, None, :]
        fill = fill + onehot.sum(dim=1)
    return dispatch, combine, gates, idx


def moe_capacity(group: int, top_k: int, capacity_factor: float, num_experts: int) -> int:
    """Slots per expert and group: ceil(group * k * cf / E), at least k."""
    capacity = int(np.ceil(group * top_k * capacity_factor / num_experts))
    return max(capacity, top_k)


def moe_ffn(params, x, *, num_experts: int, top_k: int, capacity_factor: float,
            group: int | None = None, mean=None, tp=None):
    """x (B, S, d) -> (out (B, S, d), {"moe_lb_loss", "moe_z_loss"} f32
    scalars).  The B * S tokens form groups of ``min(group, B * S)``
    (``group`` None: :data:`GROUP`).
    ``mean`` maps the aux losses' means over these tokens to means over a
    larger batch (a data-parallel step's ranks; None: these tokens are
    the batch).  ``tp``: the rank's experts (module docstring)."""
    xin = x if tp is None else tp.copy(x)
    b, s, d = xin.shape          # under tp.seq_parallel the gathered sequence
    t = b * s
    group = min(GROUP if group is None else group, t)
    if t % group:
        raise ValueError(f"{t} tokens do not split into groups of {group}")
    g = t // group
    xt = xin.reshape(g, group, d)

    router_logits = torch.einsum("gsd,de->gse", xt, params["router"]).to(torch.float32)
    if tp is not None:
        router_logits = tp.gather(router_logits, -1)
    probs = torch.softmax(router_logits, dim=-1)
    capacity = moe_capacity(group, top_k, capacity_factor, num_experts)
    routed = probs if tp is None else tp.sum_grads(probs)
    dispatch, combine, gates, idx = _dispatch_tensors(routed, top_k, capacity)
    if tp is not None:
        first, count = tp.block(num_experts)
        if params["w_gate"].shape[0] != count:
            raise ValueError(f"{params['w_gate'].shape[0]} experts on a rank of a model axis "
                             f"of {tp.size} over {num_experts}")
        dispatch = dispatch[:, :, first:first + count]
        combine = combine[:, :, first:first + count]

    expert_in = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xt)
    h = F.silu(torch.einsum("egcd,edf->egcf", expert_in, params["w_gate"]))
    h = h * torch.einsum("egcd,edf->egcf", expert_in, params["w_up"])
    expert_out = torch.einsum("egcf,efd->egcd", h, params["w_down"])
    out = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), expert_out)
    out = out.reshape(b, s, d)
    if tp is not None:
        out = tp.reduce(out)

    if "shared" in params:
        out = out + mlp(params["shared"], x, tp)

    # aux: load-balance (Switch eq. 4-6) + router z-loss
    me = probs.mean(dim=(0, 1))                                       # (E,)
    one = F.one_hot(idx[..., 0], num_experts).to(torch.float32).mean(dim=(0, 1))
    z_loss = torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2)
    if mean is not None:
        me, one, z_loss = mean(me), mean(one), mean(z_loss)
    lb_loss = num_experts * torch.sum(me * one)
    return out, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}
