"""Multi-pod dry-run on the meta device: lay out and count every (arch x
shape x mesh) cell (PyTorch counterpart of ``repro/launch/dryrun.py``).

For each cell this script:
  1. builds the production mesh (``make_production_mesh``: 16 x 16 or
     2 x 16 x 16 entries of the meta device, the counterpart of the
     reference's 512 placeholder CPU devices),
  2. constructs the abstract params/optimizer/cache state and inputs (meta
     tensors + ``Placement``s: nothing is allocated) and sums the bytes of
     each leaf the step uses on its most loaded position:
     ``argument_bytes`` per device, exact (as ``jax.jit`` drops unused
     arguments, the encoder's weights do not count in a decoder step),
  3. runs the step once on meta tensors under a ``census.StepCensus`` (the
     counterpart of lowering, compiling and reading the HLO), over one
     data row's share of the batch (``global_batch`` / (pod x data)) with
     the ``model`` axis unsplit, because the port has no partitioner: the
     live peak is ``temp_bytes`` (``temp_basis: "data_shard"``, an upper
     bound along ``model``), the FLOPs, bytes and exchanges times the data
     rows are the whole mesh's (``flops_total``, ``bytes_total``), and
     divided by the devices they are per device,
  4. appends one JSON record per cell to ``results/dryrun_torch.jsonl``
     (never the reference's ``results/dryrun.jsonl``).

The census's FLOPs are model FLOPs (products only); XLA's also count
elementwise ops, so the two packages' ``flops`` are not compared.  Outputs
the port writes in place (AdamW's params and moments, the KV caches) are
aliased to their arguments; the others count at their data-row size.  The
port runs no GSPMD collectives: ``collectives`` are the explicit exchanges
(the EP block's all-to-alls) of the whole mesh (``collectives_basis:
"explicit"``), ``collective_bytes`` their bytes per device.  A cell fits
where ``peak_bytes`` <= ``--device-bytes`` (the card's memory on a host
with one, else the H100 SXM's 80 GB).

With ``--device cuda`` each cell that fits one card also runs on a
one-entry mesh of the card, at its data row's batch: its allocator bytes
beside the census's, and the census of the step on the card, which must
equal the census on meta.

Usage:
  python -m repro_torch.launch.dryrun                    # all cells, 1-pod
  python -m repro_torch.launch.dryrun --multi-pod        # all cells, 2 pods
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --variant sp       # hillclimb variants
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.distributed import sharding
from repro_torch.launch.census import StepCensus, collective_census
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import encdec, layers
from repro_torch.models import model as model_lib

# The H100 SXM's memory, where no card can be asked.
H100_DEVICE_BYTES = 80 * 10 ** 9
_DATA_AXES = ("pod", "data")


def device_bytes_default() -> int:
    """The card's memory on a host with one, else ``H100_DEVICE_BYTES``."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return H100_DEVICE_BYTES


def _rules_for(cfg, variant: str, mesh):
    """Sharding-rule overrides per arch + hillclimb variant."""
    msize = mesh.shape.get("model", 1)
    rules = {}
    if cfg.n_heads % msize != 0:
        # Heads don't divide the model axis (deepseek-coder 56H): fall back
        # to attention sequence-sharding for the score tensors.
        rules["seq_attn"] = "model"
    if "sp" in variant.split("+"):
        # Megatron-style sequence parallelism on the residual stream.
        rules["seq"] = "model"
    if variant == "dp_only":
        rules.update({k: None for k in ("heads", "kv_heads", "mlp", "experts", "vocab")})
    return rules


def _cfg_for_variant(cfg, variant: str):
    """Hillclimb variants that change the model program itself."""
    for part in variant.split("+"):
        if part == "flash":
            cfg = cfg.replace(attention_impl="chunked", attention_chunk=1024)
        elif part == "flash512":
            cfg = cfg.replace(attention_impl="chunked", attention_chunk=512)
        elif part == "ep":
            cfg = cfg.replace(moe_impl="ep")
        elif part == "dus":
            cfg = cfg.replace(cache_update="dus")
    return cfg


def _w16(variant: str) -> bool:
    return "w16" in variant.split("+")


# Per-arch dry-run overrides: models whose f32 master state cannot fit the
# pod (see TrainConfig.param_dtype) and depth/size-driven microbatch counts.
TRAIN_OVERRIDES = {
    "deepseek-v2-236b": dict(param_dtype="bfloat16", microbatches=8),
    "deepseek-coder-33b": dict(microbatches=8),
    "chameleon-34b": dict(microbatches=8),
}


# ---------------------------------------------------------------------------
# Cells: (step, arguments, their Placements) under the current mesh
# ---------------------------------------------------------------------------


def _train_cell(cfg, shape, tcfg: TrainConfig):
    state, state_pl = model_lib.abstract_train_state(cfg, tcfg)
    batch, batch_pl = model_lib.input_specs(cfg, shape)

    def step(st, b):
        return model_lib.train_step(st, b, cfg, tcfg)

    # The step writes the new params and moments into the state it is
    # given (the reference's donate_argnums=(0,)).
    return step, (state, batch), (state_pl, batch_pl)


def _params(cfg, w16: bool):
    return layers.abstract_params(model_lib.build_schema(cfg),
                                  dtype=torch.bfloat16 if w16 else torch.float32)


def _prefill_cell(cfg, shape, w16: bool = False):
    params, params_pl = _params(cfg, w16)
    specs, specs_pl = model_lib.input_specs(cfg, shape)
    name = "frames" if cfg.enc_dec else "tokens"
    if cfg.enc_dec:

        def step(p, frames):
            return model_lib.encdec_prefill(p, frames, cfg, max_len=shape.seq_len)
    else:

        def step(p, tokens):
            return model_lib.prefill(p, tokens, cfg)

    return step, (params, specs[name]), (params_pl, specs_pl and specs_pl[name])


def _decode_cell(cfg, shape, w16: bool = False):
    params, params_pl = _params(cfg, w16)
    specs, specs_pl = model_lib.input_specs(cfg, shape)
    token, token_pl = specs["token"], specs_pl and specs_pl["token"]
    b = shape.global_batch
    if cfg.enc_dec:
        # Decoder decode: self cache + precomputed cross K/V over the source.
        enc, _ = model_lib._sds((b, min(shape.seq_len, cfg.max_source_len), cfg.d_model),
                                torch.bfloat16, "batch", "seq_kv", "embed")
        caches = encdec.init_caches(params, enc, cfg, shape.seq_len)
        caches, caches_pl = model_lib._abstract_like(
            caches, model_lib._axes_like(caches, model_lib.cache_axes))
        pos, pos_pl = model_lib._sds((b,), torch.int32, "stream")

        def step(p, tok, c, q):
            return encdec.decode_step(p, tok, c, q, cfg)

        return step, (params, token, caches, pos), (params_pl, token_pl, caches_pl, pos_pl)

    state, state_pl = model_lib.abstract_serve_state(cfg, b, shape.seq_len)

    def step(p, st, tok):
        return model_lib.serve_step(p, st, tok, cfg)

    # The KV cache updates in place (the reference donates the serve state).
    return step, (params, state, token), (params_pl, state_pl, token_pl)


def _cell_for(cfg, shape, tcfg_mb, w16: bool = False):
    if shape.kind == "train":
        return _train_cell(cfg, shape, tcfg_mb)
    if shape.kind == "prefill":
        return _prefill_cell(cfg, shape, w16)
    return _decode_cell(cfg, shape, w16)


# ---------------------------------------------------------------------------
# Bytes per device, and the census of a cell
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _with_placements(args, placements) -> list:
    """(leaf, its Placement or None) for every tensor leaf of ``args``, in
    ``_leaves`` order; ``placements`` has args' structure, or None where a
    subtree has none."""
    if isinstance(args, dict):
        return [x for k, v in args.items()
                for x in _with_placements(v, None if placements is None else placements[k])]
    if isinstance(args, (tuple, list)):
        return [x for i, v in enumerate(args)
                for x in _with_placements(v, None if placements is None else placements[i])]
    return [(args, placements)] if isinstance(args, torch.Tensor) else []


def device_bytes(t: torch.Tensor, placement) -> int:
    """Bytes of ``t`` on the most loaded mesh position of ``placement``
    (all of it without one)."""
    if placement is None:
        return t.numel() * t.element_size()
    most = 0
    for index in placement.indices_map(tuple(t.shape)).values():
        n = 1
        for dim, sl in zip(t.shape, index):
            n *= len(range(*sl.indices(dim)))
        most = max(most, n)
    return most * t.element_size()


def _row_mesh(mesh):
    """One data row of ``mesh``: its data axes cut to 1 (same entries, same
    axis names)."""
    sizes = tuple(1 if a in _DATA_AXES else n for a, n in zip(mesh.axis_names, mesh.sizes))
    return sharding.Mesh(mesh.devices[:math.prod(sizes)], mesh.axis_names, sizes)


def data_rows(mesh) -> int:
    return math.prod(n for a, n in zip(mesh.axis_names, mesh.sizes) if a in _DATA_AXES)


def _local_shape(shape, rows: int):
    """The cell's shape for one data row: the batch split over the rows
    where it divides (else every row holds all of it, as ``resolve``
    replicates a batch that does not divide)."""
    b = shape.global_batch
    return dataclasses.replace(shape, global_batch=b // rows if b % rows == 0 else b)


def _tcfg(arch: str, shape, microbatches: int) -> TrainConfig:
    """The reference's: ``TRAIN_OVERRIDES`` over ``microbatches``, at most
    one microbatch a row of the global batch."""
    over = dict(TRAIN_OVERRIDES.get(arch, {}))
    mb = min(over.pop("microbatches", microbatches), shape.global_batch)
    return TrainConfig(microbatches=mb, **over)


def _local_tcfg(tcfg: TrainConfig, local_batch: int) -> TrainConfig:
    """The microbatch count that splits one data row's batch (the reference
    splits the global batch into ``microbatches`` slices, each over the
    data rows)."""
    return dataclasses.replace(tcfg, microbatches=math.gcd(tcfg.microbatches, local_batch))


def census_cell(cfg, shape, mesh, rules, tcfg: TrainConfig, w16: bool = False,
                device: str = "meta", args=None, trace: bool = False) -> dict:
    """Run the cell's step once under a census on one data row of ``mesh``
    (``args``: the data row's arguments, made on ``device`` if not given):
    the whole mesh's FLOPs, bytes and exchanges, the row's live peak and
    its outputs (new, and aliased to an argument)."""
    row = _row_mesh(mesh) if device == "meta" else mesh
    rows = data_rows(mesh)
    local = _local_shape(shape, rows)
    ltcfg = _local_tcfg(tcfg, local.global_batch)
    with sharding.activate(row, rules):
        step, abstract, _ = _cell_for(cfg, local, ltcfg, w16)
        if args is None:
            args = abstract
        tensors = [x for x in _leaves(args) if isinstance(x, torch.Tensor)]
        held = {t.untyped_storage()._cdata: i for i, t in enumerate(tensors)}
        t0 = time.perf_counter()
        with StepCensus(watch=tensors, trace=trace) as c:
            out = step(*args)
        seconds = time.perf_counter() - t0
    aliased, new_bytes = set(), 0
    for t in _leaves(out):
        if not isinstance(t, torch.Tensor):
            continue
        key = t.untyped_storage()._cdata
        if key in held:
            aliased.add(held[key])
        else:
            new_bytes += t.numel() * t.element_size()
    coll = collective_census(c)
    whole = {k: {"count": v["count"] * rows, "bytes": v["bytes"] * rows}
             for k, v in coll.items() if k != "total_bytes"}
    whole["total_bytes"] = coll["total_bytes"] * rows
    return dict(
        flops_total=c.flops * rows, bytes_total=c.bytes_accessed * rows,
        collectives=whole, temp_bytes=c.peak_live_bytes, new_output_bytes=new_bytes,
        aliased=aliased, used=c.used | aliased, kernel_calls=dict(c.kernel_calls), seconds=seconds,
        local_batch=local.global_batch, microbatches=ltcfg.microbatches, trace=c.trace)


def cost_extrapolation(cfg, shape, mesh, rules, param_dtype, w16=False) -> dict:
    """Per-device FLOPs, bytes and exchange bytes at full depth from the
    censuses of two shrunk depths, cost(L) = a + b L (embed, logits and
    optimizer in a, per layer in b): the reference's fit of its unrolled
    1- and 2-layer compiles.  Hybrid stacks fit in pattern groups (1 and 2
    whole groups, no tail); the encoder-decoder varies both stacks
    together (equal depths).  A meta census runs every layer, so this is
    exact where the cost is linear in the depth."""
    if cfg.hybrid_pattern:
        p = len(cfg.hybrid_pattern)
        l1, l2 = p, 2 * p  # 1 and 2 full groups, no tail
    else:
        l1, l2 = 1, 2

    def shrink(n):
        kw = dict(n_layers=n, unroll_layers=True)
        if cfg.enc_dec:
            kw["n_enc_layers"] = n
        return cfg.replace(**kw)

    n_dev = len(mesh.devices)
    tcfg = TrainConfig(microbatches=1, param_dtype=param_dtype)

    def cost(n):
        r = census_cell(shrink(n), shape, mesh, rules, tcfg, w16)
        return {"flops": r["flops_total"] / n_dev, "bytes": r["bytes_total"] / n_dev,
                "coll": r["collectives"]["total_bytes"] / n_dev}

    c1, c2 = cost(l1), cost(l2)
    out = {}
    for k in ("flops", "bytes", "coll"):
        slope = (c2[k] - c1[k]) / (l2 - l1)
        base = c1[k] - slope * l1
        out[k] = base + slope * cfg.n_layers
    return out


# ---------------------------------------------------------------------------
# The cell on the card
# ---------------------------------------------------------------------------


def materialize(cfg, shape, tcfg: TrainConfig, w16: bool, device, seed: int = 0):
    """The cell's arguments as a user builds them on ``device``: params
    drawn from ``seed`` (a fresh ``TrainState`` to train), a fresh serve
    state or the encoder-decoder's caches of zeros, inputs of token 0 and
    label 0 (frames of zeros)."""
    schema = model_lib.build_schema(cfg)
    b, s = shape.global_batch, shape.seq_len

    def ints(*dims):
        return torch.zeros(dims, dtype=torch.int32, device=device)

    if shape.kind == "train":
        state = model_lib.init_train_state(cfg, seed, tcfg, device=device)
        batch = {"tokens": ints(b, s), "labels": ints(b, s), "odl_labels": ints(b)}
        if cfg.enc_dec:
            batch["frames"] = torch.zeros((b, s, cfg.d_model), device=device)
        return state, batch
    params = layers.init_params(schema, seed, device,
                                dtype=torch.bfloat16 if w16 else torch.float32)
    if shape.kind == "prefill":
        if cfg.enc_dec:
            return params, torch.zeros((b, s, cfg.d_model), device=device)
        return params, ints(b, s)
    if cfg.enc_dec:
        _, _, caches, _ = _decode_cell(cfg, shape, w16)[1]
        caches = model_lib._map_path(
            lambda _, t: torch.zeros(t.shape, dtype=t.dtype, device=device), caches)
        return params, ints(b, 1), caches, ints(b)
    return params, model_lib.init_serve_state(cfg, b, s, device=device), ints(b, 1)


def _allocator_settings(settings: str) -> None:
    """The CUDA caching allocator's settings, changed in this process (the
    accelerator-wide call where torch has it)."""
    set_ = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (set_ or torch.cuda.memory._set_allocator_settings)(settings)


def _first_difference(a: list, b: list):
    """Where two census traces part: (index, a's call, b's call), or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    if len(a) != len(b):
        n = min(len(a), len(b))
        return n, a[n] if n < len(a) else None, b[n] if n < len(b) else None
    return None


def card_run(cfg, shape, tcfg: TrainConfig, w16: bool, rules=None, device="cuda",
             seed: int = 0, limit=None) -> dict:
    """The cell (at ``shape``'s batch) on a one-entry (data, model) mesh of
    the card against its census on a one-entry mesh of the meta device:
    the census's per-device argument bytes beside the allocator's bytes
    for building the arguments (``requested`` as asked, ``allocated`` in
    the allocator's 512-byte blocks), its live peak beside the step's
    allocator peak, and the card's census against the meta census (FLOPs,
    bytes and exchanges must be equal).  Where ``limit`` is given and the
    meta census's arguments + live peak exceed it, the card is not asked:
    ``status`` says why."""
    rules = rules or {}
    dev = torch.device(device)
    axes = ("data", "model")
    meta_mesh = make_mesh((1, 1), axes, ["meta"])
    with sharding.activate(meta_mesh, rules):
        _, abstract, placements = _cell_for(cfg, shape, tcfg, w16)
    pairs = _with_placements(abstract, placements)
    arg_b = sum(device_bytes(t, pl) for t, pl in pairs)
    meta = census_cell(cfg, shape, meta_mesh, rules, tcfg, w16, trace=True)
    if limit is not None and arg_b + meta["temp_bytes"] > limit:
        return dict(status="skipped", argument_bytes=arg_b, temp_bytes=meta["temp_bytes"],
                    reason=f"does not fit one card: {arg_b + meta['temp_bytes']} > {limit} bytes")

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    # Expandable segments, so that every block is carved at its size
    # rounded to 512 bytes (a fresh segment keeps up to 1 MB of an unsplit
    # remainder in its block otherwise).
    _allocator_settings("expandable_segments:True")
    try:
        stats0 = torch.cuda.memory_stats(dev)
        a0 = torch.cuda.memory_allocated(dev)
        args = materialize(cfg, shape, tcfg, w16, dev, seed)
        torch.cuda.synchronize(dev)
        built = _leaves(args)
        real = [t for t in built if isinstance(t, torch.Tensor)]
        if [(tuple(t.shape), t.dtype) for t, _ in pairs] != \
                [(tuple(t.shape), t.dtype) for t in real]:
            raise RuntimeError("the materialized arguments differ from the abstract ones")
        a1 = torch.cuda.memory_allocated(dev)
        stats1 = torch.cuda.memory_stats(dev)
        requested = None
        key = "requested_bytes.all.current"
        if key in stats1:
            requested = stats1[key] - stats0[key]
        torch.cuda.reset_peak_memory_stats(dev)
        card_mesh = make_mesh((1, 1), axes, [dev])
        card = census_cell(cfg, shape, card_mesh, rules, tcfg, w16, device=device, args=args,
                           trace=True)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - a0
        del args, built, real
    finally:
        torch.cuda.empty_cache()
        _allocator_settings("expandable_segments:False")
    return dict(
        status="ok", argument_bytes=arg_b, n_leaves=len(pairs), allocated_bytes=a1 - a0,
        requested_bytes=requested, temp_bytes=meta["temp_bytes"],
        card_temp_bytes=card["temp_bytes"], peak_allocated_bytes=peak,
        flops_meta=meta["flops_total"], flops_card=card["flops_total"],
        bytes_meta=meta["bytes_total"], bytes_card=card["bytes_total"],
        collectives_meta=meta["collectives"], collectives_card=card["collectives"],
        census_equal=(meta["flops_total"] == card["flops_total"]
                      and meta["bytes_total"] == card["bytes_total"]
                      and meta["collectives"] == card["collectives"]),
        first_difference=_first_difference(meta["trace"], card["trace"]),
        kernel_calls=card["kernel_calls"], seconds=card["seconds"])


# ---------------------------------------------------------------------------
# A cell's record
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, multi_pod: bool, variant: str = "base",
             microbatches: int = 8, *, device: str = "meta", device_bytes_limit=None) -> dict:
    """One cell's record; ``device="cuda"`` adds the cell's data row run on
    a one-entry mesh of the card (``card``)."""
    cfg = _cfg_for_variant(configs.get_config(arch), variant)
    shape = configs.shape_by_name(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    limit = device_bytes_limit or device_bytes_default()
    rec = {
        "arch": arch,
        "shape": shape.name,
        "mesh": "x".join(str(n) for n in mesh.sizes),
        "variant": variant,
        "kind": shape.kind,
        "n_devices": len(mesh.devices),
    }
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        rec.update(status="skipped", reason="full attention is quadratic at 524k")
        return rec
    if shape.kind == "decode" and cfg.enc_dec and shape.name == "long_500k":
        rec.update(status="skipped", reason="enc-dec decoder capped below 500k")
        return rec

    t0 = time.time()
    rules = _rules_for(cfg, variant, mesh)
    tcfg = _tcfg(arch, shape, microbatches)
    w16 = _w16(variant)
    with sharding.activate(mesh, rules):
        _, args, placements = _cell_for(cfg, shape, tcfg, w16)
    pairs = _with_placements(args, placements)
    per_leaf = [device_bytes(t, pl) for t, pl in pairs]
    c = census_cell(cfg, shape, mesh, rules, tcfg, w16)
    # The arguments the step reads, writes or returns (the reference's jit
    # drops the others: the encoder's weights in a decoder step).
    arg_b = sum(per_leaf[i] for i in c["used"])
    alias_b = sum(per_leaf[i] for i in c["aliased"])
    out_b = alias_b + c["new_output_bytes"]
    tmp_b = c["temp_bytes"]
    n_dev = len(mesh.devices)
    peak = arg_b + max(out_b - alias_b, 0) + tmp_b
    rec.update(
        status="ok",
        census_s=round(time.time() - t0, 1),
        raw_flops=c["flops_total"] / n_dev,
        raw_bytes_accessed=c["bytes_total"] / n_dev,
        argument_bytes=arg_b,
        output_bytes=out_b,
        temp_bytes=tmp_b,
        alias_bytes=alias_b,
        # Live bytes per device: outputs written in place alias their inputs.
        peak_bytes=peak,
        temp_basis="data_shard",
        flops=c["flops_total"] / n_dev,
        bytes_accessed=c["bytes_total"] / n_dev,
        flops_total=c["flops_total"],
        bytes_total=c["bytes_total"],
        collective_bytes=c["collectives"]["total_bytes"] / n_dev,
        collectives=c["collectives"],
        collectives_basis="explicit",
        device_bytes=limit,
        fits=peak <= limit,
    )
    if device != "meta":
        local = _local_shape(shape, data_rows(mesh))
        ltcfg = _local_tcfg(tcfg, local.global_batch)
        r = card_run(cfg, local, ltcfg, w16, rules, device, limit=limit)
        rec["card"] = dict(batch=local.global_batch, **r)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--device", default="meta", choices=("meta", "cuda"),
                    help="cuda: also run each cell that fits on a one-entry mesh of the card")
    ap.add_argument("--device-bytes", type=int, default=None,
                    help="memory of one device (default: the card's, else 80 GB)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: --device cuda and no CUDA device", file=sys.stderr)
        return 1

    archs = [args.arch] if args.arch else list(configs.ARCH_IDS)
    shapes = [args.shape] if args.shape else [s.name for s in configs.LM_SHAPES]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    failures = 0
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    try:
                        rec = run_cell(arch, shape, mp, args.variant, args.microbatches,
                                       device=args.device,
                                       device_bytes_limit=args.device_bytes)
                    except Exception as e:  # noqa: BLE001 — report and continue
                        failures += 1
                        rec = {
                            "arch": arch, "shape": shape,
                            "mesh": "2x16x16" if mp else "16x16",
                            "variant": args.variant, "status": "error",
                            "error": f"{type(e).__name__}: {e}",
                        }
                        traceback.print_exc()
                    print(json.dumps({k: v for k, v in rec.items() if k != "collectives"}))
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
    print(f"done; failures={failures}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
