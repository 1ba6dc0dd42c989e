"""Training driver: data pipeline -> train_step -> checkpoint/restart
(PyTorch counterpart of ``repro/launch/train.py``).

Runs every backbone: the dense, MoE (GQA and MLA attention), SSD and
hybrid stacks and the encoder-decoder (whisper, fed the reference's
stubbed frames: standard normal (B, S, d_model) f32 drawn from ``step``),
on the card (or the CPU with ``--device cpu``, at smoke width).  Fault tolerance as in the reference: async keep-3
checkpoints every ``ckpt_every`` steps, a NaN guard that rolls back to the
last good checkpoint and skips the offending batch, and deterministic
seekable data (``TokenStream.batch(step)``), so a run restored at step N
sees the same remaining batches and ends bit for bit as an uninterrupted
one.  Each step writes the state in place (``model.train_step``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --variant smoke \\
      --steps 50 --batch 8 --seq 64 --ckpt-dir <dir> [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, convert, resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.models import model as model_lib
from repro_torch.runtime import fault
from repro_torch.runtime.checkpoint import CheckpointManager


def make_step(cfg: ModelConfig, tcfg: TrainConfig):
    def step(state, batch):
        return model_lib.train_step(state, batch, cfg, tcfg)

    return step


def frames(step: int, batch: int, seq: int, d_model: int) -> np.ndarray:
    """The encoder-decoder's stubbed frame embeddings of ``step``, the
    reference's draw: (batch, seq, d_model) standard normal f32."""
    return np.random.default_rng(step).normal(0, 1, (batch, seq, d_model)).astype(np.float32)


def train(
    arch: str,
    variant: str = "smoke",
    steps: int = 50,
    batch: int = 8,
    seq: int = 64,
    ckpt_dir: str | None = None,
    ckpt_every: int = 20,
    seed: int = 0,
    microbatches: int = 1,
    log_every: int = 10,
    device=None,
    cfg: ModelConfig | None = None,
    on_step=None,
    tcfg: TrainConfig | None = None,
):
    """Train ``arch``/``variant`` (or ``cfg``, a config given outright) for
    ``steps`` steps on ``device`` (CUDA unless named); returns (state,
    losses of the steps this call ran).  ``tcfg`` replaces the default
    ``TrainConfig(microbatches=microbatches)`` (bf16 master params, say).
    A ``ckpt_dir`` that holds a checkpoint resumes from its latest step.  ``on_step(step, metrics)``,
    if given, is called after every step that was kept."""
    device = resolve_device(device)
    cfg = cfg or configs.get_config(arch, variant)
    tcfg = tcfg or TrainConfig(microbatches=microbatches)
    stream = TokenStream(
        TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                          n_domains=cfg.odl.n_out, seed=seed)
    )
    step_fn = make_step(cfg, tcfg)
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    guard = fault.NaNGuard(mgr) if mgr else None

    start = 0
    if mgr and mgr.latest_step() is not None:
        start, tree = mgr.restore()
        state = convert.train_state_from_numpy(tree, cfg, device, tcfg)
        print(f"restored checkpoint at step {start}")
    else:
        state = model_lib.init_train_state(cfg, seed, tcfg, device)

    losses = []
    t0 = time.time()
    for step in range(start + 1, steps + 1):
        batch_np = stream.batch(step)
        if cfg.enc_dec:
            batch_np["frames"] = frames(step, batch, seq, cfg.d_model)
        batch_t = {k: torch.as_tensor(v, device=device) for k, v in batch_np.items()}
        state, metrics = step_fn(state, batch_t)
        loss = float(metrics["loss"])
        losses.append(loss)
        if guard:
            tree, _, rolled = guard.check(step, metrics, state)
            if rolled:
                state = convert.train_state_from_numpy(tree, cfg, device, tcfg)
                continue
        if mgr and step % ckpt_every == 0:
            mgr.save_async(step, state)
        if on_step is not None:
            on_step(step, metrics)
        if step % log_every == 0 or step == steps:
            print(
                f"step {step:5d} loss {loss:8.4f} odl_q {float(metrics['odl_query_frac']):.2f}"
                f" odl_acc {float(metrics['odl_acc']):.2f} theta {float(metrics['odl_theta']):.2f}"
                f" ({(time.time()-t0)/max(step-start,1):.2f}s/step)"
            )
    if mgr:
        mgr.wait()
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=configs.ARCH_IDS)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device to train on (default: CUDA; with no CUDA device it "
                    "exits before building anything)")
    args = ap.parse_args(argv)
    # No card and no --device: fail here, before anything is built.
    device = resolve_device(args.device)
    _, losses = train(
        args.arch, args.variant, args.steps, args.batch, args.seq,
        args.ckpt_dir, microbatches=args.microbatches, seed=args.seed, device=device,
    )
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    else:
        print(f"no steps to run: the checkpoint is already at step {args.steps} or later")


if __name__ == "__main__":
    main()
