"""Fault-tolerant training loop.

A port of ``src/repro/launch/train.py``: deterministic step-keyed data,
periodic (async) checkpoints, resume from the latest on start, bounded
per-step retries, and a failure injector (``--fail-at-step N`` fails the
step once; the loop restores and the run ends with the params of an
uninterrupted one).  Runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
      --steps 300 --ckpt-dir build/ckpt --task copy
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from .. import configs
from ..bitset import resolve_device
from ..checkpoint import Checkpointer
from ..data import DataConfig, batch_for_step
from ..models import init_params
from ..train import AdamWConfig, init_train_state, make_train_step


class SimulatedFailure(RuntimeError):
    pass


def train_loop(cfg, dc: DataConfig, opt: AdamWConfig, steps: int,
               ckpt: Checkpointer, *, ckpt_every: int = 50,
               fail_at_step: int = -1, log_every: int = 20,
               max_retries: int = 3, remat: bool = False,
               device="cuda") -> dict:
    """Train ``steps`` steps from params of seed 0 (or the latest
    checkpoint) on ``device`` (default: the card); returns the state.
    ``remat`` passes to ``make_train_step``."""
    dev = resolve_device(device)

    def fresh():
        return init_train_state(cfg, init_params(cfg, 0, device=dev), opt,
                                device=dev)
    state = fresh()
    start = 0
    if ckpt.latest_step() is not None:
        start, state = ckpt.restore(state, device=dev)
        print(f"[train] resumed from step {start}")
    step_fn = make_train_step(cfg, opt, remat=remat)

    failed_once = False
    step = start
    while step < steps:
        batch = batch_for_step(dc, step, device=dev)
        for _ in range(max_retries):
            try:
                if step == fail_at_step and not failed_once:
                    failed_once = True
                    raise SimulatedFailure(f"injected failure @ {step}")
                t0 = time.time()
                state, metrics = step_fn(state, batch)
                dt = time.time() - t0
                break
            except SimulatedFailure as e:
                print(f"[train] {e} -> restoring last checkpoint")
                if ckpt.latest_step() is not None:
                    step, state = ckpt.restore(state, device=dev)
                    print(f"[train] recovered at step {step}")
                else:
                    state = fresh()
                    step = 0
                batch = batch_for_step(dc, step, device=dev)
        else:
            raise RuntimeError(f"step {step} failed {max_retries} times")
        step += 1
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss={float(metrics['loss']):.4f}"
                  f" gnorm={float(metrics['grad_norm']):.3f}"
                  f" {dt*1e3:.0f}ms", flush=True)
        if step % ckpt_every == 0:
            ckpt.save(step, state)
    ckpt.save(steps, state)
    ckpt.wait()   # the final save lands before the caller tears down
    return state


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--task", default="copy", choices=["copy", "lm"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dc = DataConfig(task=args.task, vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch,
                    n_media_tokens=cfg.n_media_tokens, d_model=cfg.d_model)
    opt = AdamWConfig(lr=args.lr, warmup_steps=20, decay_steps=args.steps)
    ckpt = Checkpointer(args.ckpt_dir, keep=3, async_save=True)
    train_loop(cfg, dc, opt, args.steps, ckpt, ckpt_every=args.ckpt_every,
               fail_at_step=args.fail_at_step, device=args.device)
    print("[train] done")


if __name__ == "__main__":
    main()
