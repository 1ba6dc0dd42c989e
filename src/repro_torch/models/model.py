"""Top-level model API (PyTorch counterpart of ``repro/models/model.py``):
build / train_step / prefill / serve_step / decode_step / serve_apply_labels.

``train_step`` is one optimizer step of the backbone (CE loss -> grads ->
AdamW, ``optim/adam.py``), plus the OS-ELM head trained by rank-k RLS on the
pooled features, with P1P2 pruning deciding which rows may skip the teacher
(``odl_update``): a pruned row is masked out of the RLS update (the one-head
RLS kernel on the card) and costs no label.  The head takes no gradient.
Master params are f32 (``TrainConfig.param_dtype``); the backbone computes
in bf16, as the reference does.  The step writes the new params and moments
into the ``TrainState`` it is given (the reference's jitted step donates
it): a caller that needs the old state clones it first.  Dense, MoE (GQA
or MLA attention), SSD and hybrid RG-LRU stacks and the encoder-decoder
(whisper) serve and train; an MoE stack's loss adds 0.01 times its
layers' load-balancing aux loss, as the reference's does.  The
encoder-decoder serves through ``encdec_prefill`` and
``encdec.decode_step``, as the reference's does: the decoder-only serving
entry points below raise for it.

Every backbone carries the paper's ODL head: ``serve_step`` decodes one
token, then the fleet engine's ``gate`` runs on each stream's last hidden
state (the ODLHash projection kernel and the plan's per-stream pass on the
card): the per-stream prediction, the P1P2/auto-theta decision of which
streams must consult the teacher (a ``GateOutput`` with the ``queried``
mask and the plan-time decision context), the drift detector and the comm
meter.  Label application is asynchronous: ``serve_apply_labels`` is fed
the same ``GateOutput``, so a delayed answer is judged at query-time
context, and runs the fleet RLS kernel.  ``decode_step`` is the gate-free
variant the multiplexed serving path uses.

A state laid out on a (data, model) mesh by ``place_train_state`` trains
through ``partitioned_train_step`` (the dense and MoE stacks, GQA or MLA):
its params and moments stay the slices their ``Placement``s name.

A serving step writes the KV caches in place: the ``ServeState`` passed in
is consumed, as the reference's jitted serving loop donates it.

The dry-run's abstract state (``abstract_serve_state``,
``abstract_train_state``, ``input_specs``) is built on the meta device:
each returns a tree of meta tensors and, under a mesh, the matching tree
of ``sharding.Placement``s (else None), as ``layers.abstract_params`` does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch import engine, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import drift as drift_mod
from repro_torch.core import oselm, pruning
from repro_torch.distributed import sharding
from repro_torch.models import encdec, layers, transformer
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.optim import adam

# ---------------------------------------------------------------------------
# Schema / configs / params
# ---------------------------------------------------------------------------


def build_schema(cfg: ModelConfig) -> dict:
    if cfg.enc_dec:
        return encdec.encdec_schema(cfg)
    return transformer.lm_schema(cfg)


def stacked_names(cfg: ModelConfig) -> list:
    """The top-level subtrees of the schema whose leaves stack layers (or
    pattern groups): ``layers``; ``groups`` and ``tail`` for a hybrid
    stack; ``enc_layers`` and ``dec_layers`` for the encoder-decoder."""
    return [name for name, sub in build_schema(cfg).items() if isinstance(sub, dict)
            and next(leaf for _, leaf in layers._iter_leaves(sub)).axes[0] == "layers"]


def elm_config(cfg: ModelConfig) -> oselm.OSELMConfig:
    return oselm.OSELMConfig(
        n_in=cfg.d_model,
        n_hidden=cfg.odl.n_hidden,
        n_out=cfg.odl.n_out,
        variant=cfg.odl.variant,
        seed=cfg.odl.seed,
        ridge=cfg.odl.ridge,
        use_kernel=cfg.odl.use_kernel,
    )


@functools.lru_cache(maxsize=32)
def core_config(cfg: ModelConfig) -> engine.EngineConfig:
    """Fleet-engine config for this backbone's per-stream ODL heads."""
    ecfg = elm_config(cfg)
    return engine.EngineConfig(
        elm=ecfg,
        prune=pruning.PruneConfig.for_hidden(ecfg.n_hidden),
        drift=drift_mod.DriftConfig(),
    )


def build_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """A serving model's params from ``seed`` on ``device`` (CUDA unless
    named): matmul and embedding weights in bf16, norm weights in f32."""
    return layers.init_params(build_schema(cfg), seed, device, dtype=layers.serving_dtype)


# ---------------------------------------------------------------------------
# Training state
# ---------------------------------------------------------------------------


class ODLState(NamedTuple):
    elm: oselm.OSELMState
    prune: pruning.PruneState


class TrainState(NamedTuple):
    params: dict
    opt: adam.AdamState
    odl: ODLState


def init_odl_state(cfg: ModelConfig, device=None) -> ODLState:
    device = resolve_device(device)
    return ODLState(elm=oselm.init_state(elm_config(cfg), device),
                    prune=pruning.init_state(device))


def init_train_state(cfg: ModelConfig, seed: int = 0, tcfg: TrainConfig = TrainConfig(),
                     device=None) -> TrainState:
    """Master params in ``tcfg.param_dtype`` (f32 by default) drawn from
    ``seed`` on ``device`` (CUDA unless named), zero moments, a fresh head."""
    device = resolve_device(device)
    params = layers.init_params(build_schema(cfg), seed, device,
                                dtype=getattr(torch, tcfg.param_dtype))
    return TrainState(params=params, opt=adam.init(params), odl=init_odl_state(cfg, device))


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------


def _forward_loss(params, batch, cfg: ModelConfig, remat: bool):
    if cfg.enc_dec:
        enc = encdec.encode(params, batch["frames"], cfg, remat=remat)
        hidden = encdec.decode_train(params, batch["tokens"], enc, cfg, remat=remat)
        logits = encdec.logits(params, hidden)
        aux = 0.0
    else:
        hidden, aux = transformer.lm_hidden(params, batch["tokens"], cfg, remat=remat)
        logits = transformer.lm_logits(params, hidden, cfg)
    ce = softmax_cross_entropy(logits, batch["labels"])
    loss = ce + 0.01 * aux
    feats = torch.mean(hidden.float(), dim=1)  # (B, d) pooled
    return loss, (ce, feats)


def loss_and_grads(params: dict, batch: dict, cfg: ModelConfig, remat: bool = True):
    """(loss, feats (B, d) f32 detached, grads): the gradient of the loss with
    respect to every param, a tree like ``params`` in the params' dtype.

    Autograd differentiates one view per layer (per group of a hybrid
    stack) of each stacked leaf (``stacked_names``), whose ``.grad`` is
    preset to the matching slice of a zeroed stacked buffer, so each
    layer's gradient is added into place: a stacked leaf's gradient is
    never assembled from per-layer copies (at full width a layer-stacked
    leaf is 3.6 GB in f32)."""
    names = stacked_names(cfg)
    grads, inputs = {}, {}
    for name in names:
        grads[name] = _map(torch.zeros_like, params[name])
        depth = adam.leaves(params[name])[0].shape[0]
        inputs[name] = [_map(functools.partial(_layer_view, i=i), params[name], grads[name])
                        for i in range(depth)]
    top = _map(lambda v: v.detach().requires_grad_(),
               {k: v for k, v in params.items() if k not in names})
    loss, (_, feats) = _forward_loss(dict(top, **inputs), batch, cfg, remat)
    loss.backward()
    grads.update(_map(lambda v: v.grad if v.grad is not None else torch.zeros_like(v), top))
    return loss.detach(), feats.detach(), grads


def _layer_view(p, g, i):
    """Layer i of the stacked leaf ``p`` as a leaf of its own whose gradient
    accumulates into layer i of ``g``."""
    v = p[i].detach().requires_grad_()
    v.grad = g[i]
    return v


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# ODL head update (the paper's technique, fused into the train step)
# ---------------------------------------------------------------------------


def odl_update(
    odl: ODLState,
    feats: torch.Tensor,  # (B, d_model) f32
    odl_labels: torch.Tensor,  # (B,) int teacher labels
    cfg: ModelConfig,
    drift_active: Optional[torch.Tensor] = None,
) -> tuple[ODLState, dict]:
    """Predict, gate against the batch-start theta, RLS-train the head on
    the queried rows (the pruned ones masked out), then replay the ladder
    row by row (``pruning.scan_update``)."""
    ecfg = elm_config(cfg)
    pcfg = pruning.PruneConfig.for_hidden(ecfg.n_hidden)
    if drift_active is None:
        drift_active = torch.zeros((), dtype=torch.bool, device=feats.device)

    preds, outs = oselm.predict(odl.elm, feats, ecfg)  # (B,), (B, m)
    conf = pruning.confidence(outs)
    theta = pruning.theta_of(odl.prune, pcfg)
    warm = odl.elm.count >= pcfg.min_trained
    prune_mask = warm & ~drift_active & (conf > theta)
    queried = ~prune_mask  # (B,)

    # One-hot by a comparison: the same ops on every device (F.one_hot takes
    # a range check with a host sync on the CPU only), so a census of the
    # step counts alike on the CPU, the card and the meta device.
    classes = torch.arange(ecfg.n_out, device=odl_labels.device)
    y = (odl_labels.long()[:, None] == classes).to(torch.float32)
    new_elm = oselm.sequential_update(odl.elm, feats, y, ecfg, mask=queried.to(torch.float32))
    agree = preds == odl_labels
    new_prune = pruning.scan_update(odl.prune, queried, agree, conf, pcfg)

    metrics = {
        "odl_query_frac": torch.mean(queried.to(torch.float32)),
        "odl_acc": torch.mean(agree.to(torch.float32)),
        "odl_theta": theta,
    }
    return ODLState(elm=new_elm, prune=new_prune), metrics


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def accumulate_grads(params: dict, batch: dict, cfg: ModelConfig,
                     tcfg: TrainConfig = TrainConfig(), grads_fn=None):
    """(loss, feats (B, d) f32, grads) of one batch: ``loss_and_grads`` (or
    ``grads_fn``, which takes the same arguments), or with
    ``tcfg.microbatches`` = mb > 1 over mb slices along B, the gradients
    summed in f32, each divided by mb, and the slices' features
    concatenated."""
    grads_fn = grads_fn or loss_and_grads
    mb = tcfg.microbatches
    if mb == 1:
        return grads_fn(params, batch, cfg, tcfg.remat)

    def split(x, i):
        return x.reshape((mb, x.shape[0] // mb) + tuple(x.shape[1:]))[i]

    grads, loss, feats_mb = None, 0.0, []
    for i in range(mb):
        loss_i, feats_i, g = grads_fn(params, {k: split(v, i) for k, v in batch.items()}, cfg,
                                      tcfg.remat)
        if grads is None:  # 0 + g / mb, as a zeroed f32 sum would hold it
            grads = _map(lambda b: b.float() / mb, g)
        else:
            _map(lambda a, b: a.add_(b.float() / mb), grads, g)
        loss = loss + loss_i / mb
        feats_mb.append(feats_i)
        del g  # before the next slice's gradients exist
    return loss, torch.cat(feats_mb), grads


def train_step(
    state: TrainState,
    batch: dict,
    cfg: ModelConfig,
    tcfg: TrainConfig = TrainConfig(),
) -> tuple[TrainState, dict]:
    """One optimizer step with optional gradient accumulation.

    batch: tokens/labels (B, S) [+ frames (B, S, d) f32 for the
    encoder-decoder] + odl_labels (B,), tensors on the state's device.  The
    gradients are ``accumulate_grads``'s; the head trains on all B rows'
    features at once.  The params and moments of ``state`` are updated in
    place.  The backbone's step and the head's update run under the
    profiler ranges ``train.backbone`` and ``train.head``.

    A state from ``place_train_state`` (params and moments ``Sharded``)
    runs the partitioned step on the current mesh instead
    (``partitioned_train_step``); a state of whole tensors runs the step
    above under a mesh or without one.
    """
    if is_partitioned(state):
        return partitioned_train_step(state, batch, cfg, tcfg)
    with torch.profiler.record_function("train.backbone"):
        loss, feats, grads = accumulate_grads(state.params, batch, cfg, tcfg)
        new_params, new_opt, gnorm = adam.update(grads, state.opt, state.params, tcfg)
    with torch.profiler.record_function("train.head"):
        new_odl, odl_metrics = odl_update(state.odl, feats, batch["odl_labels"], cfg)
    metrics = {"loss": loss, "grad_norm": gnorm, **odl_metrics}
    return TrainState(params=new_params, opt=new_opt, odl=new_odl), metrics


# ---------------------------------------------------------------------------
# The partitioned training step: params and moments held as their
# Placements' slices on a (data, model) mesh
# ---------------------------------------------------------------------------
#
# The reference's step under a mesh is one program that GSPMD partitions by
# the leaves' layouts (``abstract_train_state``): tensor-parallel heads,
# d_ff and vocabulary over "model", FSDP leaves over "data", ZeRO-1
# moments.  Here the same step is written as phases over the mesh
# positions with the collectives between them (``transformer.lm_hidden_tp``
# and ``lm_logits_tp``, ``layers.vocab_parallel_cross_entropy``,
# ``adam.update_partitioned``), in one autograd graph across the positions.
#
# Every position of a data row holds that row's residual stream and
# computes its losses, the same bits at each, but only the row's home
# position (model index 0) sends its losses to the loss: the loss is the
# mean over the whole batch's tokens of the home positions' rows, gathered
# onto the mesh's first entry, plus 0.01 times an MoE stack's aux loss,
# which its layers gather onto that entry.  As a function of the params every copy is
# the same function, so autograd's gradient of that loss is the true one:
# a leaf slice used at several positions gets the sum of its uses'
# gradients (summed in the backward pass for a slice gathered from one
# shard, and over the positions that hold the same slice afterwards, in
# ``adam.reduce_to_moments``), none counted twice.


def require_partitionable(cfg: ModelConfig) -> None:
    """Raise for the stacks the partitioned step does not run: it runs the
    dense decoder stacks and the MoE stacks (GQA or MLA attention, SwiGLU
    or the MoE block in every layer)."""
    if cfg.enc_dec or cfg.hybrid_pattern or cfg.family == "ssm":
        raise NotImplementedError(
            f"{cfg.arch_id}: the partitioned training step runs the dense and MoE decoder "
            "stacks only; the SSD, hybrid and encoder-decoder stacks on partitioned leaves, and "
            "one process per card, are ROADMAP.md Queue 1 item 6.5's open steps (3)-(6) (a "
            "state of whole tensors under a mesh trains them)")


def is_partitioned(state: TrainState) -> bool:
    """Whether the state's params are ``sharding.Sharded`` (``place_train_state``)."""
    return isinstance(adam.leaves(state.params)[0], sharding.Sharded)


def place_train_state(state: TrainState, mesh: sharding.Mesh, cfg: ModelConfig,
                      tcfg: TrainConfig = TrainConfig()) -> TrainState:
    """``state`` laid out on ``mesh`` by ``abstract_train_state(cfg, tcfg)``'s
    Placements under it: every param and moment a ``Sharded`` of copies of
    its slices, each on its entry (``runtime.checkpoint.reshard_tree``).
    The step and the head, which the reference replicates, are held once,
    on the mesh's first entry, where the head's update runs."""
    from repro_torch.runtime import checkpoint

    with sharding.activate(mesh):
        _, pl = abstract_train_state(cfg, tcfg)
    specs = _map(lambda p: p.spec, checkpoint.shardings_for_schema(build_schema(cfg), mesh))
    mspecs = _map(lambda p: p.spec, pl.opt.m)
    first = mesh.devices[0]
    return TrainState(
        params=checkpoint.reshard_tree(state.params, mesh, specs),
        opt=adam.AdamState(step=state.opt.step.to(first),
                           m=checkpoint.reshard_tree(state.opt.m, mesh, mspecs),
                           v=checkpoint.reshard_tree(state.opt.v, mesh, mspecs)),
        odl=_map_path(lambda _, t: t.to(first), state.odl))


def gather_train_state(state: TrainState) -> TrainState:
    """A partitioned state as whole tensors on its mesh's first entry."""
    def whole(t):
        return t.gather() if isinstance(t, sharding.Sharded) else t

    return TrainState(params=_map(whole, state.params),
                      opt=adam.AdamState(step=state.opt.step, m=_map(whole, state.opt.m),
                                         v=_map(whole, state.opt.v)),
                      odl=state.odl)


def train_layout(cfg: ModelConfig, placements: dict) -> tuple[dict, dict]:
    """(top, layer): {path: (held spec, compute spec)} of the top-level
    leaves and of the layer leaves (without the layers dim), from the
    params' ``placements`` and ``layers.compute_spec``."""
    top, layer = {}, {}
    for path, leaf in layers._iter_leaves(build_schema(cfg)):
        spec = _at(placements, path).spec
        if path[0] == "layers":
            held = list(spec) + [None] * (len(leaf.shape) - len(spec))
            if held[0] is not None:
                raise NotImplementedError(f"{'/'.join(path)}: its layers dim is split ({spec})")
            sub = layers.Leaf(leaf.shape[1:], leaf.axes[1:])
            held = sharding.PartitionSpec(*held[1:])
            layer["/".join(path[1:])] = (held, layers.compute_spec(sub, held))
        else:
            top[path[0]] = (spec, layers.compute_spec(leaf, spec))
    return top, layer


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _current_mesh(params: dict) -> sharding.Mesh:
    """The params' mesh, which must be current (``sharding.activate``) with
    axes ("data", "model")."""
    mesh = sharding.mesh_or_none()
    held = adam.leaves(params)[0].placement.mesh
    if mesh != held or mesh.axis_names != ("data", "model"):
        raise ValueError(f"a partitioned state on {held.shape} needs its (data, model) mesh "
                         f"current, not {None if mesh is None else mesh.shape}")
    return mesh


def partitioned_loss_and_grads(params: dict, batch: dict, cfg: ModelConfig, remat: bool = True):
    """(loss, feats (B, d) f32 detached, grads) of one batch on the params'
    mesh, which is current: ``loss_and_grads`` for ``Sharded`` params.  The
    batch splits over "data" by the ``batch`` rule.  The loss and the
    features (the home positions' rows, in batch order) are on the mesh's
    first entry; ``grads`` is a tree like ``params`` whose leaves are {pos:
    the gradient of the loss through that position's uses of its slice},
    in the params' dtype (``adam.update_partitioned`` sums them)."""
    mesh = _current_mesh(params)
    top_layout, layer_layout = train_layout(cfg, _map(lambda sh: sh.placement, params))
    b, s = batch["tokens"].shape
    if b % mesh.shape["data"]:
        raise ValueError(f"a batch of {b} rows does not split over {mesh.shape['data']} data rows")
    rows = sharding.Placement(mesh, sharding.resolve("batch", "seq", shape=(b, s)))
    tokens, labels = (rows.place(batch[k]).shards for k in ("tokens", "labels"))
    grads = _map(lambda sh: {pos: torch.zeros_like(t) for pos, t in sh.shards.items()},
                 params)
    top = {name: {pos: t.detach().requires_grad_() for pos, t in params[name].shards.items()}
           for name in top_layout}
    stacked = {}
    for path in layer_layout:
        sh, g = _at(params["layers"], path.split("/")), _at(grads["layers"], path.split("/"))
        stacked[path] = [{pos: _layer_view(t, g[pos], i) for pos, t in sh.shards.items()}
                         for i in range(cfg.n_layers)]
    layout = dict(top_layout, **layer_layout)
    hidden, aux = transformer.lm_hidden_tp(top, stacked, tokens, cfg, mesh, layout, remat)
    logits = transformer.lm_logits_tp(top, hidden, cfg, mesh, layout)
    ce = layers.vocab_parallel_cross_entropy(logits, labels, mesh,
                                             transformer.vocab_split(cfg, layout))
    del logits
    first = next(iter(mesh.positions()))
    homes = [(i, 0) for i in range(mesh.shape["data"])]  # each data row's first position
    loss = torch.mean(torch.cat([sharding.exchange(ce[pos], pos, first, mesh, "gather")
                                 for pos in homes]))
    if cfg.n_experts:  # one copy of the aux, on the first entry
        loss = loss + 0.01 * aux
    feats = torch.cat([sharding.exchange(torch.mean(hidden[pos].float(), dim=1).detach(), pos,
                                         first, mesh, "gather") for pos in homes])
    loss.backward()
    for name, parts in top.items():
        grads[name] = {pos: t.grad if t.grad is not None else torch.zeros_like(t)
                       for pos, t in parts.items()}
    return loss.detach(), feats, grads


def partitioned_train_step(state: TrainState, batch: dict, cfg: ModelConfig,
                           tcfg: TrainConfig = TrainConfig()) -> tuple[TrainState, dict]:
    """``train_step`` on a state from ``place_train_state``, under its mesh
    (``sharding.activate``): the batch (tensors on any device) is split
    over "data", the gradients accumulated over ``tcfg.microbatches`` as
    ``accumulate_grads`` does, AdamW runs on each position's slices
    (``adam.update_partitioned``), and the head trains on the gathered
    features on the mesh's first entry.  The new state keeps every leaf's
    placement; nothing is gathered whole."""
    require_partitionable(cfg)
    mesh = _current_mesh(state.params)
    with torch.profiler.record_function("train.backbone"):
        loss, feats, grads = accumulate_grads(state.params, batch, cfg, tcfg,
                                              partitioned_loss_and_grads)
        new_params, new_opt, gnorm = adam.update_partitioned(grads, state.opt, state.params,
                                                             tcfg, mesh)
    with torch.profiler.record_function("train.head"):
        new_odl, odl_metrics = odl_update(state.odl, feats,
                                          batch["odl_labels"].to(feats.device), cfg)
    metrics = {"loss": loss, "grad_norm": gnorm, **odl_metrics}
    return TrainState(params=new_params, opt=new_opt, odl=new_odl), metrics


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


class ServeState(NamedTuple):
    caches: dict
    pos: torch.Tensor  # (B,) int32
    odl: engine.EngineState  # fleet engine: elm/prune/drift/meter, leading B


def init_serve_state(cfg: ModelConfig, batch: int, max_len: int, device=None) -> ServeState:
    device = resolve_device(device)
    return ServeState(
        caches=transformer.init_caches(cfg, batch, max_len, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
        odl=engine.init_fleet(core_config(cfg), batch, device),
    )


def _decode(params, state: ServeState, token, cfg, out=None):
    with torch.profiler.record_function("serve.backbone"):
        hidden, caches = transformer.lm_decode_hidden(params, token, state.caches, state.pos,
                                                      cfg, out)
        logits = transformer.lm_logits(params, hidden, cfg)[:, 0]
    return logits, hidden[:, 0].float(), caches


def serve_step(
    params: dict,
    state: ServeState,
    token: torch.Tensor,  # (B, 1) int
    cfg: ModelConfig,
) -> tuple[torch.Tensor, ServeState, engine.GateOutput]:
    """One decode token + the fleet engine's predict/gate on stream features.

    Returns (logits (B, V), state', odl_out) where odl_out is the engine's
    ``GateOutput``: the per-stream prediction, confidence, ``queried`` mask
    (True -> this stream must consult the teacher), and the plan-time
    decision context that ``serve_apply_labels`` judges the (possibly
    delayed) teacher answer against.
    """
    logits, feats, caches = _decode(params, state, token, cfg)
    with torch.profiler.record_function("serve.head"):
        new_odl, odl_out = engine.gate(state.odl, feats, core_config(cfg))
    return logits, ServeState(caches=caches, pos=state.pos + 1, odl=new_odl), odl_out


def decode_step(
    params: dict,
    state: ServeState,
    token: torch.Tensor,  # (B, 1) int
    cfg: ModelConfig,
    out: Optional[dict] = None,
) -> tuple[torch.Tensor, torch.Tensor, ServeState]:
    """One decode token *without* the ODL gate: (logits, feats (B, d) f32,
    state').  The multiplexed serving path runs the backbone once and fans
    the features out to tenant fleets, each with its own engine state;
    ``state.odl`` passes through untouched.  ``out`` receives the recurrent
    cache leaves' new values (``transformer.lm_decode_hidden``)."""
    logits, feats, caches = _decode(params, state, token, cfg, out)
    return logits, feats, state._replace(caches=caches, pos=state.pos + 1)


def serve_apply_labels(
    state: ServeState,
    ctx: engine.GateOutput,  # gate output captured at query time
    labels: torch.Tensor,  # (B,) teacher labels (valid where mask)
    mask: torch.Tensor,  # (B,) bool — streams whose teacher answered
    cfg: ModelConfig,
) -> ServeState:
    """Asynchronous label acquisition: RLS-train the per-stream heads
    against the query-time context ``ctx``."""
    with torch.profiler.record_function("serve.head"):
        new_odl = engine.apply_labels(state.odl, ctx, labels, mask, core_config(cfg))
    return state._replace(odl=new_odl)


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, max_len: Optional[int] = None):
    """Forward the prompt once and build decode caches, on the tokens'
    device.  Returns (final_hidden, ServeState ready for serve_step)."""
    hidden, caches, pos = transformer.lm_prefill(params, tokens, cfg, max_len)
    state = ServeState(
        caches=caches, pos=pos,
        odl=engine.init_fleet(core_config(cfg), tokens.shape[0], tokens.device),
    )
    return hidden, state


def encdec_prefill(params: dict, frames: torch.Tensor, cfg: ModelConfig, max_len: int):
    """The encoder-decoder's prefill, on the frames' device: (encoder states
    (B, T, d), decode caches for ``encdec.decode_step`` with ``max_len``
    self-attention slots)."""
    enc = encdec.encode(params, frames, cfg)
    return enc, encdec.init_caches(params, enc, cfg, max_len)


# ---------------------------------------------------------------------------
# Abstract state builders (dry-run: meta tensors + Placements only)
# ---------------------------------------------------------------------------


def _is_record(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _map_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and NamedTuples, the path a
    tuple of keys and field names."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if _is_record(tree):
        return type(tree)(*(_map_path(fn, v, path + (f,)) for f, v in zip(tree._fields, tree)))
    return fn(path, tree)


def _map_with(fn, tree, other):
    """``fn(leaf, other's leaf)`` over ``tree``'s structure (``other`` has
    it too, its leaves of any kind)."""
    if isinstance(tree, dict):
        return {k: _map_with(fn, v, other[k]) for k, v in tree.items()}
    if _is_record(tree):
        return type(tree)(*(_map_with(fn, v, getattr(other, f))
                            for f, v in zip(tree._fields, tree)))
    return fn(tree, other)


def _abstract_like(tree, axes_tree):
    """A tree of tensors (meta or not) + its logical-axes tree -> (the
    leaves as meta tensors, their Placements under the current mesh, else
    None)."""
    metas = _map_path(lambda _, t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
    if sharding.mesh_or_none() is None:
        return metas, None
    return metas, _map_with(lambda t, axes: sharding.named_sharding(*axes, shape=tuple(t.shape)),
                            metas, axes_tree)


def _axes_like(tree, fn):
    """An axes tree with ``tree``'s structure by ``fn(path, leaf)``."""
    return _map_path(fn, tree)


def cache_axes(path: tuple, leaf) -> tuple:
    """Logical axes for one decode-cache leaf, keyed by leaf name + rank.

    KV/latent caches shard their sequence dim over 'model' (flash-decoding
    style length sharding — the natural decode TP axis) and batch over
    ('pod','data'); recurrent states shard heads/width over 'model'.
    """
    name = path[-1].strip("'[]")
    nd = leaf.ndim
    lead: tuple = ("layers",)  # stacked layer/group dim
    if name in ("k", "v"):  # (L, B, S, KV, hd)
        return lead + ("batch", "seq_kv", "kv_heads", None)[: nd - 1]
    if name in ("ckv", "k_rope"):  # (L, B, S, R)
        return lead + ("batch", "seq_kv", None)[: nd - 1]
    if name == "state":  # (L, B, H, P, N)
        return lead + ("batch", "ssm_heads", None, None)[: nd - 1]
    if name == "conv":  # (L, B, W-1, C)
        return lead + ("batch", None, "mlp")[: nd - 1]
    if name == "h":  # (L, B, W)
        return lead + ("batch", "mlp")[: nd - 1]
    return lead + ("batch",) + (None,) * (nd - 2)


def _stream_axes(path, leaf) -> tuple:
    return ("stream",) + (None,) * (leaf.ndim - 1)


def abstract_serve_state(cfg: ModelConfig, batch: int, max_len: int):
    """(``ServeState`` of meta tensors, its ``Placement``s or None): the
    caches by ``cache_axes``, ``pos`` and the fleet's leaves on ``stream``."""
    shapes = init_serve_state(cfg, batch, max_len, device="meta")
    caches, cache_pl = _abstract_like(shapes.caches, _axes_like(shapes.caches, cache_axes))
    pos, pos_pl = _sds((batch,), torch.int32, "stream")
    odl, odl_pl = _abstract_like(shapes.odl, _axes_like(shapes.odl, _stream_axes))
    state = ServeState(caches=caches, pos=pos, odl=odl)
    if sharding.mesh_or_none() is None:
        return state, None
    return state, ServeState(caches=cache_pl, pos=pos_pl, odl=odl_pl)


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """(``TrainState`` of meta tensors, its ``Placement``s or None): params
    TP+FSDP-sharded by ``layers.param_specs``, f32 moments ZeRO-1, the
    step and the head replicated."""
    schema = build_schema(cfg)
    params, param_pl = layers.abstract_params(schema, dtype=getattr(torch, tcfg.param_dtype))
    mesh = sharding.mesh_or_none()
    def moments():
        return layers._tree_of(schema, lambda leaf: torch.empty(
            leaf.shape, dtype=torch.float32, device="meta"))

    step = torch.empty((), dtype=torch.int32, device="meta")
    odl = init_odl_state(cfg, device="meta")
    state = TrainState(params=params, opt=adam.AdamState(step=step, m=moments(), v=moments()),
                       odl=odl)
    if mesh is None:
        return state, None

    def moment_of(p, placement):
        """ZeRO-1: moments get 'data' (and 'pod') on a free dim — unless the
        param is already FSDP-sharded over data (then moments match it)."""
        msh = mesh.shape
        entries = list(placement.spec) + [None] * (p.dim() - len(placement.spec))
        flat = [a for e in entries for a in (e if isinstance(e, tuple) else (e,))]
        if "data" not in flat:
            for axes_try in ((("pod", "data") if "pod" in msh else None), "data"):
                if axes_try is None:
                    continue
                size = msh["pod"] * msh["data"] if isinstance(axes_try, tuple) else msh["data"]
                placed = False
                for i, e in enumerate(entries):
                    if e is None and p.shape[i] % size == 0 and p.shape[i] >= size:
                        entries[i] = axes_try
                        placed = True
                        break
                if placed:
                    break
        return sharding.Placement(mesh, sharding.P(*entries))

    def replicated(_, t):
        return sharding.Placement(mesh, sharding.P())

    m_pl = _map_with(moment_of, params, param_pl)
    placements = TrainState(
        params=param_pl,
        opt=adam.AdamState(step=replicated((), step), m=m_pl, v=m_pl),
        odl=_map_path(replicated, odl))
    return state, placements


# ---------------------------------------------------------------------------
# Dry-run input specs (meta tensors + Placements, no allocation)
# ---------------------------------------------------------------------------


def _sds(shape_tuple, dtype, *names):
    """(a meta tensor of ``shape_tuple``, its Placement by ``names`` under
    the current mesh, else None)."""
    return (torch.empty(shape_tuple, dtype=dtype, device="meta"),
            sharding.named_sharding(*names, shape=tuple(shape_tuple)))


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(meta tensors of every model input of this (arch, shape) cell, by
    name; their Placements under the current mesh, else None)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        specs = {
            "tokens": _sds((b, s), i32, "batch", "seq"),
            "labels": _sds((b, s), i32, "batch", "seq"),
            "odl_labels": _sds((b,), i32, "batch"),
        }
        if cfg.enc_dec:
            specs["frames"] = _sds((b, s, cfg.d_model), torch.float32, "batch", "seq", "embed")
    elif shape.kind == "prefill":
        if cfg.enc_dec:
            specs = {"frames": _sds((b, s, cfg.d_model), torch.float32, "batch", "seq", "embed")}
        else:
            specs = {"tokens": _sds((b, s), i32, "batch", "seq")}
    else:  # decode: one new token against an S-long cache
        specs = {"token": _sds((b, 1), i32, "batch", None)}
    metas = {k: v[0] for k, v in specs.items()}
    if sharding.mesh_or_none() is None:
        return metas, None
    return metas, {k: v[1] for k, v in specs.items()}
