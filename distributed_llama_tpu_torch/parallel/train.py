"""Training over a dp x tp mesh with exact-resume checkpoints (the JAX
package's parallel/train.py).

``make_train_step(spec, group)`` gives ``(init_fn, step_fn)``: next-token
cross-entropy (the mean over every target of the global batch) through
models/llama.forward_seq on the dense f32 tree (io/loader.densify_params),
and AdamW with optax.adamw's defaults. The products are plain F.linear and
attention the port's attention_core: the JAX package computes both
outside any Pallas kernel, so training has no hand kernel.

Sharding pins the ref scheme whatever DLLAMA_TP_SCHEME says, as the JAX
package does: wq ... w3 are banded on their output rows, wcls on vocab
(``train_bands``), the embedding and the norms are replicated. Each
banded product's input passes parallel/collectives.tp_enter (identity,
its gradient all-reduced) and its output bands tp_gather (all_gather,
the gradient's own band back), so everything between products is
replicated over tp and every rank computes the replicated leaves' whole
gradient itself. A rank holds ceil(B / dp) of the batch's rows (the last
dp ranks fewer where B does not divide, as GSPMD pads); its loss is the
sum of its rows' cross-entropy over the global count of targets, and one
all_reduce over the dp group sums the gradients with the loss (the
global mean). ``train_collective_budget`` is what one step issues.

AdamW is optax's: b1 0.9, b2 0.999, eps 1e-8, eps_root 0 and weight decay
1e-4 on every leaf (norms and embeddings included; torch's AdamW defaults
to 1e-2), the update -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p) from
the pre-step p as optax computes it (torch's AdamW first scales p by
1 - lr * wd; the two agree to rounding).

The checkpoint is the JAX package's file: np.savez of ``__version__`` 1,
``__header__`` (the spec header as int32), ``__step__``, ``__n_leaves__``,
an optional ``__data_seed__``, then ``leaf_i`` in the JAX pytree order —
the params by sorted key, ``count`` (int32), ``mu`` and ``nu`` by sorted
key (3N + 1 leaves) — so each package resumes the other's state. Under tp
rank 0 gathers the bands (moments banded like their params) and writes
one global file; a load slices each rank's bands, so a state resumes on
any mesh shape. The refusals carry the JAX package's messages.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.llama import PLAIN, forward_seq
from ..models.spec import TransformerSpec
from ..ops.linear import dense_matmul
from . import collectives as C
from .mesh import TPGroup, single
from .tp import _band, _slice, validate_sharding

B1, B2, EPS, EPS_ROOT, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.0, 1e-4
# the leaves banded on their output rows: the ref scheme's 'out' leaves
# (parallel/tp.param_specs), which training pins
_BANDED = frozenset(("wq", "wk", "wv", "wo", "w1", "w2", "w3", "wcls"))
_TRAIN_CKPT_VERSION = 1


class AdamWState(NamedTuple):
    """optax.adamw's state: the step count and the first and second
    moments, each a dict like the params (bands like theirs under tp)."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def train_bands(params: dict[str, Any], rank: int,
                tp: int) -> dict[str, np.ndarray]:
    """Rank ``rank``'s share of a dense training tree under the ref
    scheme: output-row bands of wq ... w3 and wcls, the rest whole."""
    return {k: _band(v, "out" if tp > 1 and k in _BANDED else None, rank,
                     tp) for k, v in params.items()}


def _band_axis(name: str, leaf) -> int | None:
    """The axis a leaf's band cuts under the ref scheme (its output rows),
    None if replicated."""
    if name not in _BANDED:
        return None
    return leaf.ndim - 2


def tp_route(group: TPGroup):
    """forward_seq's route under tp: every dense product banded, its input
    through tp_enter and its output through tp_gather."""
    if group.size == 1:
        return PLAIN

    def dense(w, x):
        return C.tp_gather(dense_matmul(w, C.tp_enter(x, group)), group)

    return PLAIN._replace(dense=dense)


def train_collective_budget(spec: TransformerSpec, tp: int = 1, dp: int = 1,
                            sp: int = 1) -> dict[str, int]:
    """Collectives one training step issues, by census kind: under tp one
    all_gather forward and one psum backward per banded product (7 a
    layer and wcls), over dp and sp one dp_psum (gradients and loss), and
    under sp 2 (S - 1) ring hops a layer (forward and backward)."""
    out = {}
    if tp > 1:
        out["all_gather"] = out["psum"] = 7 * spec.n_layers + 1
    if dp * sp > 1:
        out["dp_psum"] = 1
    if sp > 1:
        out["ppermute"] = 2 * (sp - 1) * spec.n_layers
    return out


def _rows(n: int, group: TPGroup) -> slice:
    """The batch rows of the group's dp index: ceil(n / dp) a rank."""
    per = -(-n // group.dp_size)
    lo = min(group.dp_rank * per, n)
    return slice(lo, min(lo + per, n))


def adamw_init(params: dict[str, torch.Tensor]) -> AdamWState:
    return AdamWState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                      {k: torch.zeros_like(v) for k, v in params.items()})


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: AdamWState,
                 learning_rate: float) -> AdamWState:
    """optax.adamw's update, in place on the params and moments: each
    moment and the decayed step in optax's order of operations."""
    count = state.count + 1
    c = torch.tensor(count, dtype=torch.float32)
    bc1 = float(1 - torch.tensor(B1, dtype=torch.float32) ** c)
    bc2 = float(1 - torch.tensor(B2, dtype=torch.float32) ** c)
    for k, p in params.items():
        g = grads[k]
        mu, nu = state.mu[k], state.nu[k]
        mu.copy_((1 - B1) * g + B1 * mu)
        nu.copy_((1 - B2) * (g * g) + B2 * nu)
        u = (mu / bc1) / (torch.sqrt(nu / bc2 + EPS_ROOT) + EPS)
        u = u + WEIGHT_DECAY * p
        p.add_(-learning_rate * u)
    return AdamWState(count, state.mu, state.nu)


def _flat_sum(grads: dict[str, torch.Tensor], loss: torch.Tensor, group,
              size: int) -> torch.Tensor:
    """One all_reduce of every gradient and the loss (gradients summed in
    place); returns the summed loss."""
    names = sorted(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in names]
                     + [loss.reshape(1)])
    C.data_psum(flat, group, size)
    at = 0
    for k in names:
        n = grads[k].numel()
        grads[k].copy_(flat[at:at + n].view_as(grads[k]))
        at += n
    return flat[at]


def _device_tree(params: dict[str, Any], device) -> dict[str, torch.Tensor]:
    # a copy: the step updates its params in place
    return {k: torch.tensor(np.asarray(v, np.float32), device=device,
                            requires_grad=True) for k, v in params.items()}


def loss_and_grads(spec: TransformerSpec, params: dict[str, torch.Tensor],
                   inputs: torch.Tensor, targets: torch.Tensor, n_total: int,
                   route=PLAIN, positions=None, attention_fn=None):
    """The rows' summed next-token cross-entropy over ``n_total`` targets,
    and d(it)/d(params): a dict of fresh gradient tensors."""
    for p in params.values():
        p.grad = None
    logits = forward_seq(spec, params, inputs, positions, attention_fn,
                         route)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1), reduction="sum") / n_total
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in params.items()}
    for p in params.values():
        p.grad = None
    return loss.detach(), grads


def make_train_step(spec: TransformerSpec, group: TPGroup | None = None,
                    learning_rate: float = 1e-4, device=None):
    """Build (init_fn, step_fn) for dp x tp training.

    init_fn(params) -> (params, opt_state): the rank's bands of a dense
    numpy tree (the whole tree: every rank cuts its own), on the group's
    device. step_fn(params, opt_state, tokens (B, T+1)) -> (params,
    opt_state, loss): tokens is the global batch (numpy or a tensor), the
    rank takes its dp rows; the loss is the global mean next-token CE, a
    0-d f32 tensor. The params and moments are updated in place and
    returned. ``group`` None is the single device ``device``."""
    group = group or single(device or "cuda")
    if group.sp_size != 1:
        raise ValueError("make_train_step runs at sp 1; sequence-parallel "
                         "training is parallel/sp_train.make_sp_train_step")
    if group.size > 1:
        validate_sharding(spec, group.size, "ref")
    route = tp_route(group)

    def init_fn(params):
        bands = train_bands(params, group.rank, group.size)
        dev = _device_tree(bands, group.device)
        return dev, adamw_init(dev)

    def step_fn(params, opt_state, tokens):
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        n_total = tokens.shape[0] * (tokens.shape[1] - 1)
        mine = tokens[_rows(tokens.shape[0], group)].to(group.device)
        if mine.shape[0]:
            loss, grads = loss_and_grads(spec, params, mine[:, :-1],
                                         mine[:, 1:], n_total, route)
        else:  # more dp ranks than rows: this rank adds nothing
            loss = torch.zeros((), device=group.device)
            grads = {k: torch.zeros_like(p) for k, p in params.items()}
        if group.dp_size > 1:
            loss = _flat_sum(grads, loss, group.dp_group, group.dp_size)
        opt_state = adamw_update(params, grads, opt_state, learning_rate)
        return params, opt_state, loss

    return init_fn, step_fn


def template_params(spec: TransformerSpec) -> dict[str, np.ndarray]:
    """Zero-valued dense f32 params with the training tree's structure and
    shapes — the resume path's template (the checkpoint overwrites every
    value, so the model's weights are never read for it)."""
    p = {"tok_embedding": np.zeros((spec.vocab_size, spec.dim), np.float32),
         "rms_att": np.zeros((spec.n_layers, spec.dim), np.float32),
         "rms_ffn": np.zeros((spec.n_layers, spec.dim), np.float32),
         "rms_final": np.zeros((spec.dim,), np.float32),
         "wcls": np.zeros((spec.vocab_size, spec.dim), np.float32)}
    for name, shape in spec.layer_matmul_shapes():
        p[name] = np.zeros((spec.n_layers, *shape), np.float32)
    return p


def _leaf_names(params: dict[str, Any],
                opt_state: AdamWState) -> list[tuple[str, str | None]]:
    """(part, key) of each leaf in the JAX pytree order: params by sorted
    key, the count, mu and nu by sorted key."""
    return ([("params", k) for k in sorted(params)] + [("count", None)]
            + [("mu", k) for k in sorted(opt_state.mu)]
            + [("nu", k) for k in sorted(opt_state.nu)])


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _leaf(part: str, key: str | None, params, opt_state: AdamWState):
    if part == "count":
        return None
    part = {"params": params, "mu": opt_state.mu, "nu": opt_state.nu}[part]
    return part[key]


def _global(t: torch.Tensor, axis: int | None, group: TPGroup):
    """A band gathered to the whole leaf (every tp rank takes part)."""
    if axis is None or group.size == 1:
        return t.detach()
    return C.gather(t.detach(), group, dim=axis)


def save_train_state(path: str, spec: TransformerSpec,
                     params: dict[str, torch.Tensor], opt_state: AdamWState,
                     step: int = 0, data_seed: int | None = None,
                     group: TPGroup | None = None) -> None:
    """Persist a training state (params and AdamW moments) to one .npz in
    the JAX package's layout. Under tp every rank must call it (the bands
    are gathered); only global rank 0 writes."""
    group = group or single(next(iter(params.values())).device)
    names = _leaf_names(params, opt_state)
    payload = {}
    for i, (part, key) in enumerate(names):
        if part == "count":
            payload[f"leaf_{i}"] = np.asarray(opt_state.count, np.int32)
            continue
        t = _leaf(part, key, params, opt_state)
        # dlint: allow[D001] a checkpoint holds host arrays
        payload[f"leaf_{i}"] = _global(t, _band_axis(key, t),
                                       group).cpu().numpy()
    if group.world_rank != 0:
        return
    if data_seed is not None:
        payload["__data_seed__"] = int(data_seed)
    with open(path, "wb") as fh:  # file object: savez must not append .npz
        np.savez(fh, __version__=_TRAIN_CKPT_VERSION,
                 __header__=np.frombuffer(spec.header(), dtype=np.int32),
                 __step__=int(step), __n_leaves__=len(names), **payload)


def read_train_meta(path: str) -> dict[str, int]:
    """The step counter and, when stored, the data seed: what a resume's
    schedule needs before any state is read."""
    with np.load(path) as z:
        meta = {"step": int(z["__step__"]) if "__step__" in z.files else 0}
        if "__data_seed__" in z.files:
            meta["data_seed"] = int(z["__data_seed__"])
    return meta


def load_train_state(path: str, spec: TransformerSpec,
                     params_template: dict[str, torch.Tensor],
                     opt_state_template: AdamWState,
                     group: TPGroup | None = None,
                     return_step: bool = False):
    """Restore (params, opt_state) saved by save_train_state (of either
    package), with ``return_step`` also the saved step counter. The
    templates (an ``init_fn`` result) give the structure, each leaf's
    band, dtype and device; each loaded leaf is cut to the rank's band of
    ``group``, so a state resumes on any mesh shape. Refusals: version,
    header, leaf count, leaf shape, leaf dtype (the JAX messages)."""
    group = group or single(next(iter(params_template.values())).device)
    with np.load(path) as z:
        if int(z["__version__"]) != _TRAIN_CKPT_VERSION:
            raise ValueError(
                f"train checkpoint version {int(z['__version__'])} != "
                f"{_TRAIN_CKPT_VERSION}")
        header = z["__header__"].tobytes()
        if header != spec.header():
            raise ValueError(
                "train checkpoint header does not match the model spec "
                f"({np.frombuffer(header, np.int32).tolist()} vs "
                f"{np.frombuffer(spec.header(), np.int32).tolist()})")
        step = int(z["__step__"]) if "__step__" in z.files else 0
        leaves = [z[f"leaf_{i}"] for i in range(int(z["__n_leaves__"]))]
    names = _leaf_names(params_template, opt_state_template)
    if len(names) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template "
                         f"has {len(names)}")
    params, mu, nu, count = {}, {}, {}, 0
    for loaded, (part, key) in zip(leaves, names):
        if part == "count":
            shape, dtype = (), "int32"
        else:
            tmpl = _leaf(part, key, params_template, opt_state_template)
            axis = _band_axis(key, tmpl)
            shape = list(tmpl.shape)
            if axis is not None:
                shape[axis] *= group.size
            shape, dtype = tuple(shape), _dtype_name(tmpl)
        if loaded.shape != shape:
            raise ValueError(f"leaf shape {loaded.shape} != template "
                             f"{shape}")
        if loaded.dtype.name != dtype:
            raise ValueError(
                f"leaf dtype {loaded.dtype} != template {dtype} — "
                "exact resume needs matching precision")
        if part == "count":
            count = int(loaded)
            continue
        if axis is not None and group.size > 1:
            loaded = _slice(loaded, axis, group.rank, group.size)
        t = torch.from_numpy(np.ascontiguousarray(loaded)).to(tmpl.device)
        {"params": params, "mu": mu, "nu": nu}[part][key] = t
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    state = (params, AdamWState(count, mu, nu))
    return (*state, step) if return_step else state
