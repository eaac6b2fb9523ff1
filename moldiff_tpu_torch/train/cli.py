"""Training the MolDiff denoiser (scripts/train_drug3d.py), and the loop
that it shares with the bond predictor's trainer (bond_cli.py).

  python -m moldiff_tpu_torch.train --config configs/train/train_full_synthetic_xl_scratch.yml \
      [--resume CKPT [--reset_ema] [--reset_optim] [--override_lr LR]] [--max_iters N] \
      [--profile_at IT] [--corpus_mols M] [--device cuda|cpu] [--logdir ./logs_torch] \
      [--name NAME]

Without ``--resume`` the run starts from fresh params drawn from
``train.seed`` (Trainer.init_state: EMA a copy of them, a fresh
optimizer). The iteration loop is the JAX CLI's: ``--max_iters`` is
absolute (a resume at step 300000 with ``--max_iters 300012`` takes 12
steps); a log line every 100 iterations and at the run's first;
validation every ``train.val_freq`` iterations over at most
``train.val_batches`` batches, whose mean loss steps the scheduler; a
checkpoint every ``train.ckpt_freq`` iterations and at the end, under
``<logdir>/<name>_<time>/checkpoints/<it>.ckpt``, after which only the
``train.keep_ckpts`` newest numeric checkpoints stay (0 or absent: all).
With ``train.ckpt_async`` the checkpoints are written on a background
thread (checkpoint_async.py), joined (and the directory pruned once more)
before the run returns. ``--override_lr`` replaces the learning rate a
resume restored; ``--profile_at N`` writes a torch.profiler trace of
iteration N to ``<log dir>/profile/trace_it<N>.json`` (the JAX CLI's
``jax.profiler`` trace). Unlike the JAX CLI, a failing step raises instead
of being skipped: on the card a skipped step would hide a kernel fault.

The run's directory also holds what the JAX CLI leaves there: ``log.txt``
(every log line), a copy of the config file (when ``main`` has one),
``metrics.jsonl`` and a TensorBoard event file (utils/misc.py
MetricsWriter; ``MOLDIFF_TB=0`` leaves out the event file) with the JAX
CLI's scalars at its iterations: the ``train/*`` loss terms, grad norm,
learning rate and steps per second at iteration 1 and every 100th, and
``val/loss`` at each validation.

The config's ``parallel:`` section is read (the JAX CLI's mesh,
parallel/mesh.py): with ``num_devices`` null (every visible card) or above
1 and more than one rank, :func:`run` starts one worker process per rank
(rank r on ``cuda:r``; on the CPU, ``--device cpu`` with ``num_devices: K``
starts K gloo processes), each checks that it is on its card, and they
train as one run: data-parallel (``parallel.fsdp``: fully sharded), with
``parallel.pipe: P`` the denoiser as a GPipe pipeline of P stages
(``train.num_microbatches``, default P), with ``parallel.expert: K`` the
MoE expert banks split over K ranks, with ``parallel.graph: G`` the pair
tensors split by receiver over G ranks, or with ``parallel.model: M`` (and
``graph``, 1 by default) the MLPs' hidden widths split over M ranks
(train/trainer.py; one rank per mesh position, JAX's layout). Every rank runs
the same loader and keeps its data coordinate's rows of each batch; rank 0
alone writes log.txt, metrics.jsonl, the event file and the checkpoints. A
failed rank fails the run. With one card visible nothing changes: no
process group, no worker. ``train.ckpt_sharded`` writes each checkpoint
as a sharded directory (train/checkpoint_sharded.py), which prune and
``--resume`` read as they read a file.

The training data (:func:`load_subsets`): when the config's
``dataset.root`` is a directory, its record store (data/dataset.py
get_dataset, processed from its SDF directory on first use, as the JAX CLI
reads it); else, when the root is a corpus recipe (data/dataset.py
CORPORA), the first ``--corpus_mols`` molecules of that corpus generated in
memory, split 80/10/10; anything else raises. :func:`run` is the same path
for a caller that holds the config as a dict (the card machine has no
PyYAML).
"""
from __future__ import annotations

import argparse
import os
import shutil
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.dataset import CORPORA, get_dataset, make_corpus
from ..data.featurize import featurizer_from_config
from ..data.loader import BucketedLoader
from ..models.moldiff import MolDiff, resolve_device
from ..ops import kernels
from ..parallel import launch
from ..parallel.mesh import (DATA_AXIS, GRAPH_AXIS, PIPE_AXIS, Mesh, broadcast_leaves,
                             initialize_distributed, make_mesh_from_config, rank_device,
                             shutdown_distributed)
from ..utils.config import Config
from ..utils.misc import MetricsWriter, get_logger, get_new_log_dir, seed_all
from ..utils.profiling import StepTimer, device_memory_stats, trace
from .checkpoint_async import AsyncCheckpointer
from .optim import get_lr, set_lr, tree_leaves, tree_map
from .trainer import Trainer, batch_to_device, prune_checkpoints

DEFAULT_CORPUS_MOLS = 2000


def load_subsets(dataset_cfg, corpus_mols: int, log: Callable[[str], None]) -> Tuple[dict, str]:
    """({split: records}, "store" or "recipe") for a config's ``dataset``
    section: the record store of ``root`` when it is a directory, else the
    first ``corpus_mols`` molecules of its corpus recipe made in memory."""
    root = dataset_cfg["root"]
    t0 = time.time()
    if os.path.isdir(root):
        dataset, subsets = get_dataset(dataset_cfg)
        log(f"dataset {root}: record store {dataset.store_path} ({len(dataset)} records; "
            + ", ".join(f"{len(v)} {k}" for k, v in subsets.items())
            + f"), ready in {time.time() - t0:.1f} s")
        return subsets, "store"
    if "./" + os.path.normpath(root) in CORPORA:
        subsets = make_corpus(root, corpus_mols)
        log(f"corpus {root}: no such directory, {corpus_mols} molecules of its recipe "
            f"generated in {time.time() - t0:.1f} s ({len(subsets['train'])} train, "
            f"{len(subsets['val'])} val)")
        return subsets, "recipe"
    raise ValueError(f"dataset.root {root!r} is neither a directory nor a corpus recipe "
                     f"({sorted(CORPORA)})")


def train_scalars(aux: dict, lr: float, steps_per_sec: float) -> dict:
    """The denoiser's logged scalars (scripts/train_drug3d.py:184-191): its
    loss terms, the optional ones it reports, grad norm, lr, steps/s."""
    out = {f"train/{k}": aux[k] for k in ("loss", "loss_pos", "loss_node", "loss_edge",
                                          "grad_norm")}
    out.update({f"train/{k}": aux[k] for k in ("loss_len", "loss_v0ce", "loss_moe") if k in aux})
    out.update({"train/lr": lr, "train/steps_per_sec": steps_per_sec})
    return out


def fit(config: Config, model, featurizer, device: torch.device, resume: Optional[str],
        logdir: str, name: str, max_iters: Optional[int], corpus_mols: int,
        subsets: Optional[Dict[str, list]], log: Optional[Callable[[str], None]],
        reset_ema: bool = False, reset_optim: bool = False,
        override_lr: Optional[float] = None, profile_at: int = 0,
        config_path: Optional[str] = None, logger_name: str = "train",
        scalars: Callable[[dict, float, float], dict] = train_scalars,
        mesh: Optional[Mesh] = None, check_replicas: bool = False) -> dict:
    """The training loop of both CLIs for ``model`` (MolDiff or
    BondPredictor) -> summary: the log dir, the data source ("store",
    "recipe", or "given" for ``subsets``), one record per train step
    (iteration, bucket, loss terms, grad norm, lr, seconds, kernel
    launches, on a card the peak of allocated device memory; on a mesh also
    the seconds in collectives, on the pipe the pipeline's transfers
    (``pipe``: parallel/pipeline.py stats), on a graph axis the model's own
    collectives (``model_comm``: parallel/collectives.py stats), and with
    ``check_replicas`` whether the params (FSDP's shards) were bit-equal
    after it on the ranks that hold the same ones: each data group's
    without FSDP, each graph group's, and each pipe group's where the pipe
    runs no pipeline), the validation losses, the checkpoints written and
    the seconds each took (an async one: its snapshot), the step timer's
    summary, the metrics and event files, and the final state and
    trainer. Log lines go to ``log.txt`` and stderr, and to ``log`` when
    given; ``scalars`` maps a step's terms to the scalars written. On a
    data axis (``mesh``, this process one of its ranks) rank 0 alone logs
    and writes files."""
    train_cfg = config.train
    ckpt_sharded = bool(train_cfg.get("ckpt_sharded", False))
    rank = mesh.rank if mesh is not None else 0
    lead = rank == 0
    seed = int(train_cfg.seed)
    seed_all(seed)
    log_dir = get_new_log_dir(logdir, prefix=name) if lead else None
    if mesh is not None and mesh.world_size > 1:
        shared = [log_dir]
        dist.broadcast_object_list(shared, 0)
        log_dir = shared[0]
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    if lead:
        os.makedirs(ckpt_dir, exist_ok=True)
        if config_path:
            shutil.copyfile(config_path, os.path.join(log_dir, os.path.basename(config_path)))
        logger = get_logger(logger_name, log_dir)

    def say(msg: str) -> None:
        if lead:
            logger.info(msg)
            if log is not None:
                log(msg)

    fsdp = bool((config.get("parallel") or {}).get("fsdp", False))
    trainer = Trainer(model, train_cfg, mesh=mesh, fsdp=fsdp)
    if trainer.mesh is not None:
        if device.type == "cuda" and torch.cuda.current_device() != device.index:
            raise RuntimeError(f"rank {rank} runs on cuda:{torch.cuda.current_device()}, "
                               f"not on its card {device}")
        axes = "".join(f", {a} axis: {n} ranks" for a, n in mesh.shape.items() if a != DATA_AXIS)
        say(f"data axis: {trainer.n_data} ranks ({mesh.backend}){' FSDP' if fsdp else ''}{axes}"
            f"{' (pipeline)' if trainer.pp else ''}"
            f"{' (plain route, pair tensors split by receiver)' if trainer.graph else ''}"
            f"{' (tensor parallel)' if trainer.tp else ''}")
    # one stream from the seed: the initial params (when not resumed), then
    # every step's noise
    gen = torch.Generator(device=device).manual_seed(seed)
    if resume:
        state = trainer.load_checkpoint(resume, device)
        say(f"resumed from {resume} at step {state.step} | device {device}")
        if reset_ema and state.ema_params is not None:
            state = state._replace(ema_params=tree_map(lambda p: p.detach().clone(),
                                                       state.params))
            say("EMA re-seeded from restored params (--reset_ema)")
        if reset_optim:
            state = state._replace(opt_state=trainer.optimizer.init(state.params))
            trainer.scheduler.reset()
            say("optimizer + scheduler state reset (--reset_optim)")
        if override_lr:
            set_lr(state.opt_state, override_lr)
            say(f"override LR -> {override_lr} (--override_lr)")
    else:
        state = trainer.init_state(gen)
        say(f"initialised from train.seed {seed} | device {device}")
    n_params = sum(p.numel() for p in tree_leaves(trainer.gathered(state).params))
    for p in tree_leaves(state.params):
        if p.device != device:
            raise RuntimeError(f"rank {rank}: a parameter is on {p.device}, not on {device}")
    say(f"trainable params: {n_params / 1e6:.2f}M")

    if subsets is None:
        subsets, data = load_subsets(config.dataset, corpus_mols, say)
    else:
        data = "given"
    buckets = tuple(train_cfg.get("buckets", (24, 32, 48)))
    batch_size = int(train_cfg.batch_size)
    train_loader = iter(BucketedLoader(subsets["train"], featurizer, batch_size, buckets,
                                       shuffle=True, seed=seed, infinite=True))
    val_subset = subsets.get("val") or subsets["train"]
    max_iters = int(max_iters or train_cfg.max_iters)
    val_freq = int(train_cfg.val_freq)
    ckpt_freq = int(train_cfg.get("ckpt_freq", val_freq))
    val_batches = int(train_cfg.get("val_batches", 16))
    keep = int(train_cfg.get("keep_ckpts", 0) or 0)
    async_ckpt = (AsyncCheckpointer() if train_cfg.get("ckpt_async", False) and not ckpt_sharded
                  else None)

    writer = MetricsWriter(log_dir) if lead else None
    timer = StepTimer()
    steps: List[dict] = []
    vals: List[dict] = []
    ckpts: List[str] = []
    ckpt_s: List[float] = []
    first = state.step + 1
    t_log = time.time()
    try:
        for it in range(first, max_iters + 1):
            batch = batch_to_device(next(train_loader), device)
            noise = trainer.draw_step_noise(batch, gen)
            before = dict(kernels.launch_counts)
            t0 = time.perf_counter()
            if it == profile_at:
                path = os.path.join(log_dir, "profile", f"trace_it{it}.json")
                with trace(path):
                    state, aux = trainer.train_step(state, batch, noise)
                say(f"profiler trace of iteration {it} written to {path}")
            else:
                state, aux = trainer.train_step(state, batch, noise)
            aux = {k: float(v) for k, v in aux.items()}
            dt = time.perf_counter() - t0
            timer.tick()
            lr = get_lr(state.opt_state)
            steps.append({"it": it, "n": int(batch["node_type"].shape[1]), "s": dt,
                          "launches": {k: kernels.launch_counts[k] - before[k] for k in before},
                          **aux, "lr": lr})
            if device.type == "cuda":
                steps[-1]["peak_bytes"] = torch.cuda.max_memory_allocated(device)
            if trainer.mesh is not None:
                steps[-1]["comm_s"] = trainer.comm_s
                if trainer.pp:
                    steps[-1]["pipe"] = trainer.pipe_stats
                if trainer.graph:
                    steps[-1]["model_comm"] = trainer.model_comm
                if check_replicas:
                    # the ranks that hold the same params (or FSDP shards):
                    # along data (without FSDP), along graph, and along a
                    # pipe that runs no pipeline
                    replicas = [a for a in mesh.axes if a == GRAPH_AXIS
                                or (a == DATA_AXIS and not trainer.fsdp)
                                or (a == PIPE_AXIS and not trainer.pp)]
                    same = all(broadcast_leaves(state.params, src=mesh.group_rank(axis, 0),
                                                group=mesh.group(axis))[1] for axis in replicas)
                    flag = torch.tensor([0.0 if same else 1.0], device=mesh.comm_device())
                    dist.all_reduce(flag)
                    steps[-1]["replicas_equal"] = float(flag[0]) == 0.0
            if it % 100 == 0 or it == first:
                elapsed = time.time() - t_log
                sps = (100 if it > first else 1) / elapsed
                t_log = time.time()
                terms = " ".join(f"{k} {v:.4f}" for k, v in aux.items()
                                 if k not in ("loss", "grad_norm"))
                say(f"[it {it}] loss {aux['loss']:.4f} ({terms}) "
                    f"| grad {aux['grad_norm']:.2f} | lr {lr:.2e} | {sps:.2f} it/s")
                # the JAX CLI's scalars, at its iterations (a resume's first
                # iteration is logged, not written)
                if lead and (it % 100 == 0 or it == 1):
                    for tag, value in scalars(aux, lr, sps).items():
                        writer.add_scalar(tag, value, it)

            if it % val_freq == 0:
                val_loader = BucketedLoader(val_subset, featurizer, batch_size, buckets,
                                            shuffle=False, infinite=False, drop_last=False,
                                            prefetch=0)
                losses = []
                for vb, vbatch in enumerate(val_loader):
                    if vb >= val_batches:
                        break
                    vbatch = batch_to_device(vbatch, device)
                    vnoise = trainer.draw_noise(vbatch, gen)
                    losses.append(float(trainer.eval_step(state.params, vbatch, vnoise)["loss"]))
                val_loss = float(np.mean(losses)) if losses else float("nan")
                state = trainer.scheduler_step(state, val_loss)
                vals.append({"it": it, "loss": val_loss, "batches": len(losses),
                             "lr": get_lr(state.opt_state)})
                say(f"[val {it}] loss {val_loss:.4f}")
                if lead:
                    writer.add_scalar("val/loss", val_loss, it)

            if it % ckpt_freq == 0 or it == max_iters:
                path = os.path.join(ckpt_dir, f"{it}.ckpt")
                t_ck = time.perf_counter()
                if ckpt_sharded:
                    trainer.save_checkpoint_sharded(path, state, config)
                elif async_ckpt is not None:
                    whole = trainer.gathered(state)
                    if lead:
                        async_ckpt.save(path, whole, config, scheduler=trainer.scheduler)
                else:
                    trainer.save_checkpoint(path, state, config)
                ckpts.append(path)
                ckpt_s.append(time.perf_counter() - t_ck)
                say(f"saved {path} in {ckpt_s[-1]:.3f} s")
                if lead:
                    prune_checkpoints(ckpt_dir, keep)
        if async_ckpt is not None:
            async_ckpt.wait()
            prune_checkpoints(ckpt_dir, keep)
    finally:
        if writer is not None:
            writer.close()
    say(f"done | step timer {timer.summary()} | device memory {device_memory_stats()}")
    return {"log_dir": log_dir, "data": data, "steps": steps, "val": vals, "checkpoints": ckpts,
            "checkpoint_s": ckpt_s, "timer": timer.summary(),
            "metrics": os.path.join(log_dir, "metrics.jsonl"),
            "events": writer.event_path if writer is not None else None, "state": state,
            "trainer": trainer}


def _rank_worker(rank: int, world: int, init_method: str, mesh: Mesh, build: Callable,
                 config: dict, kwargs: dict) -> dict:
    """One rank of a run on a mesh (launch.spawn's worker): joins the
    process group, builds the model on its card and fits -> the picklable
    part of the summary (rank 0's log lines under ``log_lines``)."""
    device = rank_device(mesh.device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize_distributed(init_method, world, rank, backend=mesh.backend)
    lines: List[str] = []
    # no teardown after an error: a peer may be gone, and the process's exit
    # ends the group
    out = build(config, device=device, mesh=mesh.at(rank, device), log=lines.append, **kwargs)
    shutdown_distributed()
    out = {k: v for k, v in out.items() if k not in ("state", "trainer")}
    out["log_lines"] = lines
    return out


def run_ranks(build: Callable, config: dict, device: "str | torch.device | None",
              backend: Optional[str], log: Optional[Callable[[str], None]], **kwargs) -> dict:
    """``build(config, device=..., mesh=..., log=..., **kwargs)`` (a CLI's
    in-process run) on the mesh of the config's ``parallel:`` section: in
    this process for one rank, else in one worker per rank -> rank 0's
    summary, and ``ranks``, every rank's (without state and trainer)."""
    device = resolve_device(device)
    mesh = make_mesh_from_config(config.get("parallel"), device, backend)
    if mesh.world_size <= 1:
        return build(config, device=device, mesh=None, log=log, **kwargs)
    ranks = launch.spawn(_rank_worker, mesh.world_size, args=(mesh, build, config, kwargs))
    if log is not None:
        for line in ranks[0]["log_lines"]:
            log(line)
    return dict(ranks[0], ranks=ranks, state=None, trainer=None)


def run(config: dict, resume: Optional[str] = None, device: "str | torch.device | None" = None,
        logdir: str = "./logs_torch", name: str = "train", max_iters: Optional[int] = None,
        reset_ema: bool = False, reset_optim: bool = False, override_lr: Optional[float] = None,
        profile_at: int = 0, corpus_mols: int = DEFAULT_CORPUS_MOLS,
        subsets: Optional[Dict[str, list]] = None,
        log: Optional[Callable[[str], None]] = None, config_path: Optional[str] = None,
        backend: Optional[str] = None, check_replicas: bool = False) -> dict:
    """Train MolDiff with ``config``, from ``resume`` or from scratch ->
    :func:`fit`'s summary (rank 0's of a data-parallel run, with every
    rank's under ``ranks``). ``subsets``: {"train", "val"} record lists to
    use instead of the config's dataset; ``config_path``: the file the
    config came from, copied into the log dir; ``backend``: the process
    group's (default NCCL on cards, gloo on the CPU; gloo may put several
    ranks on one card)."""
    return run_ranks(_run_local, dict(config), device, backend, log, resume=resume,
                     logdir=logdir, name=name, max_iters=max_iters, reset_ema=reset_ema,
                     reset_optim=reset_optim, override_lr=override_lr, profile_at=profile_at,
                     corpus_mols=corpus_mols, subsets=subsets, config_path=config_path,
                     check_replicas=check_replicas)


def _run_local(config: dict, device: torch.device, mesh: Optional[Mesh],
               log: Optional[Callable[[str], None]], **kwargs) -> dict:
    config = Config(config)
    featurizer = featurizer_from_config(config)
    model = MolDiff(config.model, featurizer.num_node_types, featurizer.num_edge_types,
                    device=device)
    resume = kwargs.pop("resume")
    return fit(config, model, featurizer, device, resume, kwargs.pop("logdir"),
               kwargs.pop("name"), kwargs.pop("max_iters"), kwargs.pop("corpus_mols"),
               kwargs.pop("subsets"), log, mesh=mesh, **kwargs)


def main(argv=None) -> str:
    from ..utils.config import load_config

    ap = argparse.ArgumentParser(description="train MolDiff with moldiff_tpu_torch")
    ap.add_argument("--config", required=True)
    ap.add_argument("--resume", default=None,
                    help="checkpoint to continue from (default: fresh params from train.seed)")
    ap.add_argument("--logdir", default="./logs_torch")
    ap.add_argument("--name", default=None)
    ap.add_argument("--max_iters", type=int, default=None)
    ap.add_argument("--reset_ema", action="store_true")
    ap.add_argument("--reset_optim", action="store_true")
    ap.add_argument("--override_lr", type=float, default=None,
                    help="after --resume, replace the restored learning rate")
    ap.add_argument("--profile_at", type=int, default=0,
                    help="write a torch.profiler trace of this iteration under the log dir")
    ap.add_argument("--corpus_mols", type=int, default=DEFAULT_CORPUS_MOLS,
                    help="when dataset.root is a corpus recipe and no directory: molecules "
                         "of it to generate in memory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config = load_config(args.config)
    name = args.name or os.path.splitext(os.path.basename(args.config))[0]
    out = run(config, args.resume, device=args.device, logdir=args.logdir, name=name,
              max_iters=args.max_iters, reset_ema=args.reset_ema, reset_optim=args.reset_optim,
              override_lr=args.override_lr, profile_at=args.profile_at,
              corpus_mols=args.corpus_mols, config_path=args.config)
    return out["log_dir"]
