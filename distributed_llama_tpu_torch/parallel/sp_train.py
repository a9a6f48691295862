"""Sequence-parallel training: ring attention over an sp-sharded sequence
(the JAX package's parallel/sp_train.py).

Tokens are sharded over the sp ranks in contiguous chunks: every rank runs
the transformer on its chunk (models/llama.forward_seq with the chunk's
absolute positions) and attention is parallel/ring.ring_attention, the K/V
chunks rotating around the ring once a layer; gradients flow back through
the hops. The batch is split over dp as in parallel/train.py. Params are
replicated (tp 1, as the JAX step's replicated params): the loss is the
mean over every (dp, sp) rank's targets, and one all_reduce over the
world sums the gradients with the loss. The next-token shift crosses
chunk boundaries, so the step shifts BEFORE splitting: inputs and targets
are sliced from the global (B, T+1) window, then split over sp.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.spec import TransformerSpec
from .mesh import TPGroup
from .ring import ring_attention
from .train import (_device_tree, _flat_sum, _rows, adamw_init,
                    adamw_update, loss_and_grads)


def make_sp_train_step(spec: TransformerSpec, group: TPGroup,
                       learning_rate: float = 1e-4):
    """Build (init_fn, step_fn) for dp x sp sequence-parallel training.

    step_fn(params, opt_state, tokens (B, T+1)) -> (params, opt_state,
    loss); T must divide by the group's sp size and B by its dp size. The
    loss is the global mean next-token CE: train.make_train_step's on the
    same tokens, up to the f32 order of the sums."""
    if group.size != 1:
        raise ValueError(f"sequence-parallel training replicates the "
                         f"params: tp must be 1, got {group.size}")
    import torch.distributed as dist

    n_sp = group.sp_size
    world = dist.group.WORLD if group.world_size > 1 else None

    def init_fn(params):
        dev = _device_tree(params, group.device)
        return dev, adamw_init(dev)

    def step_fn(params, opt_state, tokens):
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]  # shift FIRST
        batch, t_len = inputs.shape
        if t_len % n_sp or batch % group.dp_size:
            # the JAX step's shard_map refusal (P('dp', 'sp') inputs)
            raise ValueError(
                f"shard_map applied to the function 'local_loss' was given "
                f"argument arrays with axis sizes that are not evenly "
                f"divisible by the corresponding mesh axis sizes: inputs "
                f"of shape [{batch},{t_len}] over the mesh's dp "
                f"{group.dp_size} and sp {n_sp}")
        t_loc = t_len // n_sp
        q_start = group.sp_rank * t_loc
        rows = _rows(tokens.shape[0], group)
        cols = slice(q_start, q_start + t_loc)
        mine_in = inputs[rows, cols].to(group.device)
        mine_tg = targets[rows, cols].to(group.device)
        n_total = inputs.numel()
        hs, n_q, n_kv = spec.head_size, spec.n_heads, spec.n_kv_heads

        def ring(q, k, v):
            lead = q.shape[:-2]
            return ring_attention(
                hs, spec.kv_mul, q.reshape(*lead, t_loc, n_q, hs),
                k.reshape(*lead, t_loc, n_kv, hs),
                v.reshape(*lead, t_loc, n_kv, hs), q_start, t_loc, group)

        positions = q_start + torch.arange(t_loc, device=group.device)
        loss, grads = loss_and_grads(spec, params, mine_in, mine_tg,
                                     n_total, positions=positions,
                                     attention_fn=ring)
        if world is not None:
            loss = _flat_sum(grads, loss, world, group.world_size)
        opt_state = adamw_update(params, grads, opt_state, learning_rate)
        return params, opt_state, loss

    return init_fn, step_fn
